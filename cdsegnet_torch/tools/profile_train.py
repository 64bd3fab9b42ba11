"""Profile the port's CDSegNet CNF training step on one GPU.

Usage, from the root of a checkout::

    python -m cdsegnet_torch.tools.profile_train --out DIR

Builds the model, criteria and optimizer of `configs/scannet/cdsegnet.py`
(random weights from a seed) as `chip_smoke.py` trains them, on the config's
synthetic bucket (2 scenes, 204,800 slots, serialization depth 12), then
reports for one training step (forward, GLS loss, backward, AdamW):

- the host-clock step time (median of 5 after 3 warm-ups, each ending in a
  synchronize) and the peak device memory;
- from `torch.profiler` over 2 steps: the device time per step, the device's
  idle share, and the device time by kernel family and by kernel.

The kernel table and the host operators by self CPU time go to
``<out>/profile_train.txt``; the code is `profile_ssi`'s.
"""

from __future__ import annotations

import argparse
import json
import os
import runpy

import torch

from cdsegnet_torch.engine.optimizer import build_optimizer
from cdsegnet_torch.engine.state import make_train_step
from cdsegnet_torch.models.builder import build_model, build_model_criteria
from cdsegnet_torch.tools.profile_ssi import ROOT, card_name, host_ms, profile_steps
from cdsegnet_torch.utils.synthetic import synthetic_point_batch

TOTAL_STEPS = 1000  # OneCycle length; the profile takes the first steps


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", required=True, help="directory for profile_train.txt")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_train needs a CUDA device")
    conf = runpy.run_path(os.path.join(ROOT, "configs", "scannet", "cdsegnet.py"))
    depth = runpy.run_path(os.path.join(
        ROOT, "configs", "_base_", "default_runtime.py"))["serialization_depth"]
    cfg = conf["model"]
    model = build_model(cfg, device="cuda", generator=torch.Generator().manual_seed(0))
    opt = build_optimizer(dict(conf["optimizer"]), model, dict(conf["scheduler"]),
                          total_steps=TOTAL_STEPS,
                          param_dicts=[dict(p) for p in conf["param_dicts"]],
                          device="cuda")
    step_fn = make_train_step(model, build_model_criteria(cfg), opt, device="cuda")
    point = synthetic_point_batch(conf["bucket_num_points"], conf["scenes_per_device"],
                                  depth=depth, seed=0, device="cuda")
    step = lambda: step_fn(point)

    torch.cuda.reset_peak_memory_stats()
    res = dict(card=card_name(), slots=point.num_points,
               n_valid=int(point.mask.sum().item()), step_ms=host_ms(step, 3, 5))
    res.update(peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               points_per_s=res["n_valid"] / (res["step_ms"] / 1e3))
    print("train " + json.dumps(res), flush=True)
    profile_steps(step, 2, res, os.path.join(args.out, "profile_train.txt"))


if __name__ == "__main__":
    main()
