"""Testing entry point of the port (TTA fragment-voting evaluation).

Usage:
    python -m cdsegnet_torch.tools.test --config-file configs/scannet/cdsegnet.py \
        --checkpoint model_best [--options data.test.data_root=... ...] \
        [--num-gpus N] [--device cpu]

Counterpart of `tools/test.py`. ``--checkpoint`` names a checkpoint written
by the port's `engine.checkpoint.CheckpointManager` under
``<save_path>/model`` (an absolute path works too); an orbax checkpoint of
the JAX package is read after `convert_jax_checkpoint.py` (repository root)
has written it in that format. It runs on the GPU unless ``--device`` names
another device, and raises when there is no GPU and none is named.
``--num-gpus N`` (or ``num_devices`` in the config) tests fragment-parallel
on N ranks spawned by `parallel.dist.launch`, as `tools/train.py` trains;
under ``torchrun`` each process joins the group the environment describes.
`main(argv)` takes the arguments as a list and returns the tester after its
run, or None when it spawned the ranks. The inference rule is a config option: ``--options inference_mode=MSAI
inference_step=5`` (or ``MSFI``) runs the DDIM loop per fragment in place of
single-step inference.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional, Union

import torch

from cdsegnet_torch.engine.checkpoint import CheckpointManager
from cdsegnet_torch.engine.config import Config, parse_options
from cdsegnet_torch.engine.test import TESTERS
from cdsegnet_torch.models.builder import build_model
from cdsegnet_torch.parallel import dist
from cdsegnet_torch.utils.device import resolve_device


def load_state(cfg, checkpoint: str,
               device: Optional[Union[str, torch.device]] = None) -> torch.nn.Module:
    """Build the serving model on ``device`` and load ``checkpoint`` into it.

    The JAX tool converts an unrolled, fused training checkpoint into its
    scanned, unfused serving layout (`tools/test.py:28-87`). The port has
    one layout, unrolled and unfused, for training and serving, so the
    checkpoint loads as saved and needs no restack. Of the JAX tool's
    serving knobs only the stem has a counterpart here: ``serve_stem_mode``
    ("cond" by default, which here computes the gather stem: it is exact
    wherever JAX's "cond" takes the blocked k125 stem and keeps less
    memory, though on an H100 it is slower, `SubMConv`; "blocked" is the
    parity form as in JAX). Remat, fused gathers and gather padding are
    layout knobs the port does not have.
    """
    model_cfg = dict(cfg.model)
    backbone = model_cfg.get("backbone")
    if isinstance(backbone, dict) and backbone.get("type", "").startswith("PT-v3"):
        model_cfg["backbone"] = dict(
            backbone, stem_mode=str(cfg.get("serve_stem_mode", "cond")))
    model = build_model(model_cfg, device=device)
    mgr = CheckpointManager(os.path.join(cfg.get("save_path", "exp/default"), "model"))
    state = mgr.restore_raw(checkpoint)
    if state is None:
        raise FileNotFoundError(f"checkpoint {checkpoint!r} not found")
    model.load_state_dict(state["model"])
    return model


def main(argv: Optional[List[str]] = None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config-file", required=True)
    ap.add_argument("--checkpoint", default="model_best")
    ap.add_argument("--options", nargs="*", default=None)
    ap.add_argument("--num-gpus", type=int, default=None,
                    help="ranks to test on (default: the config's num_devices, or 1)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    argv = list(sys.argv[1:] if argv is None else argv)
    args = ap.parse_args(argv)
    cfg = Config.fromfile(args.config_file)
    cfg.merge_from_dict(parse_options(args.options))
    backend = cfg.get("dist_backend")
    torchrun = dist.init_from_env(args.device, backend)
    try:
        if dist.is_initialized():
            cfg.num_devices = dist.world_size()
            device = dist.rank_device(args.device)
        else:
            cfg.num_devices = args.num_gpus or cfg.get("num_devices") or 1
            device = resolve_device(args.device)
            if cfg.num_devices > 1:
                dist.launch(rank_main, cfg.num_devices, args=(argv,), backend=backend,
                            device=args.device)
                return None
        model = load_state(cfg, args.checkpoint, device)
        tester = TESTERS.build(
            dict(cfg.get("test", dict(type="SemSegTester"))),
            cfg=cfg, model=model, device=device,
        )
        tester.test()
        return tester
    finally:
        if torchrun:
            dist.destroy()


def rank_main(argv: Optional[List[str]]) -> None:
    """One spawned rank: `main` inside the process group `launch` built."""
    main(argv)


if __name__ == "__main__":
    main()
