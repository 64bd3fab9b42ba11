"""Timing-protocol latency of single-step inference (SSI).

Usage:
    python -m cdsegnet_torch.tools.test_time --config-file configs/scannet/cdsegnet.py \
        [--checkpoint model_best] [--num-points 104448] [--iters 10] \
        [--options k=v ...] [--device cpu]

Counterpart of `tools/test_time.py`, the paper's speed protocol: no test-time
augmentation and no fragments, one whole-scene forward. The scene is the
JAX tool's: ``--num-points`` voxels drawn uniformly from a 512^3 grid by
``numpy.random.RandomState(0)`` (2 cm voxels, ``feat_dim`` random features),
at the config's ``serialization_depth``. Weights are random from a seed, or
a port checkpoint (``--checkpoint``, as `tools.test` reads it; orbax
checkpoints of the JAX package are not read). One untimed forward, then
``--iters`` timed ones, each ending in a host read of the logits' sum (the
synchronize). Prints ``SSI latency: <ms> ms/scene, <points/s> points/s on
<device>``. The model is a `CNFSegmentor`, as in the JAX tool. It runs on
the GPU unless ``--device`` names another device. `main(argv)` returns
``dict(ms_per_scene, points_per_s)``. The JAX tool's
serve-layout knobs (scan, fused gathers, gather padding, remat) reschedule
the same computation and have no counterpart in the port.
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from cdsegnet_torch.engine.config import Config, parse_options
from cdsegnet_torch.engine.state import batch_to_point
from cdsegnet_torch.models.builder import build_model
from cdsegnet_torch.tools.test import load_state
from cdsegnet_torch.utils.device import resolve_device


def timing_scene(num_points: int, feat_dim: int) -> Dict[str, np.ndarray]:
    """The JAX tool's scene: uniform random voxels of a 512^3 grid."""
    rng = np.random.RandomState(0)
    grid = rng.randint(0, 1 << 9, size=(num_points, 3)).astype(np.int32)
    return dict(
        coord=(grid * 0.02).astype(np.float32), grid_coord=grid,
        feat=rng.randn(num_points, feat_dim).astype(np.float32),
        segment=np.zeros((num_points,), np.int32),
        batch=np.zeros((num_points,), np.int32), mask=np.ones((num_points,), bool))


def main(argv: Optional[List[str]] = None) -> Dict[str, float]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config-file", required=True)
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--num-points", type=int, default=104448)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--options", nargs="*", default=None)
    ap.add_argument("--device", default=None, help="torch device (default: the GPU)")
    args = ap.parse_args(argv)
    cfg = Config.fromfile(args.config_file)
    cfg.merge_from_dict(parse_options(args.options))
    device = resolve_device(args.device)
    model = (load_state(cfg, args.checkpoint, device) if args.checkpoint
             else build_model(dict(cfg.model), device=device)).eval()

    n = args.num_points
    point = batch_to_point(timing_scene(n, cfg.get("feat_dim", 6)),
                           cfg.get("serialization_depth", 12), 1, device)
    noise = torch.randn((n, model.c_in_channels),
                        generator=torch.Generator(device).manual_seed(7), device=device)

    ssi = lambda: model.inference(point, noise=noise)["seg_logits"]
    float(ssi().sum())
    t0 = time.perf_counter()
    for _ in range(args.iters):
        float(ssi().sum())
    dt = (time.perf_counter() - t0) / args.iters
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else str(device)
    print(f"SSI latency: {dt * 1e3:.2f} ms/scene, {n / dt:,.0f} points/s on {name}",
          flush=True)
    return dict(ms_per_scene=dt * 1e3, points_per_s=n / dt)


if __name__ == "__main__":
    main()
