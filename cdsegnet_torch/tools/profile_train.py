"""Profile the port's CDSegNet CNF training step, or its trainer, on one GPU.

Usage, from the root of a checkout::

    python -m cdsegnet_torch.tools.profile_train --out DIR \
        [--trainer | --microbatch M | --config FILE] [--warmup W --steps S --profiled P]

Without ``--trainer``: builds the model, criteria and optimizer of
``--config`` (`configs/scannet/cdsegnet.py` by default; e.g.
`configs/scannet/ptv2.py` or `configs/scannet/spunet.py`; random weights
from a seed) as `chip_smoke.py`
trains them, on the config's synthetic bucket (2 scenes, 204,800 slots,
serialization depth 12; with ``--microbatch 2`` two micro buckets of
102,400 slots, one scene each, trained in turn as `chip_smoke.py` phase 13
does), then reports for one training step (forward, loss, backward, the
config's optimizer):

- the host-clock step time (median of ``--steps`` 5 after ``--warmup`` 3,
  each ending in a synchronize) and the peak device memory;
- from `torch.profiler` over ``--profiled`` 2 steps: the device time per
  step, the device's idle share, and the device time by kernel family and
  by kernel (PTv1's step launches over a million kernels in its
  farthest-point sampling: profile it with ``--warmup 1 --steps 2
  --profiled 1``);
- for a kNN model (PTv2): the device time of its geometry alone (the
  metric pyramid and one kNN table per level, which the step builds), from
  `torch.profiler` over 2 builds, and each level's kNN ms (CUDA events).

With ``--trainer``: runs the trainer through `tools/train.py` on the same
config, as users train it (the shipped train pipeline, Mix3D, the one
prefetch thread), for one epoch over ``--rooms`` synthetic rooms under
``<out>/data`` (`utils.synthetic.room_scene`, seeds 1 to 24 by default; two
scenes per step), with the kernels built first. It reports, per iteration
(the loader's wait and the step):

- the host clock and the data wait of every iteration (`IterationTimer`);
- from `torch.profiler` over the epoch's last ``PROFILED`` iterations: the
  device time per iteration and the device's idle share, against the median
  unprofiled steady iteration (the fifth up to the profiled ones) and under
  the profiler;

then profiles the trainer's validation SSI on the val room (seed 0) in the
`EvalLoader`'s 524,288-slot bucket as above (host clock median of 5 after 2
warm-ups, `torch.profiler` over 2 calls).

The kernel tables and the host operators by self CPU time go to
``<out>/profile_train.txt`` (``profile_train_micro<M>.txt`` with
``--microbatch``, ``profile_train_<config name>.txt`` and
``profile_geometry_<config name>.txt`` with another config;
``profile_trainer.txt`` and ``profile_eval.txt``); the code is
`profile_ssi`'s.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import time

import torch

from cdsegnet_torch.engine.optimizer import build_optimizer
from cdsegnet_torch.engine.state import make_train_step
from cdsegnet_torch.models.builder import build_model, build_model_criteria
from cdsegnet_torch.tools.profile_ssi import (DEFAULT_CONFIG, ROOT, card_name, host_ms,
                                              load_config, make_profiler, profile_steps,
                                              report)
from cdsegnet_torch.utils.synthetic import synthetic_point_batch

TOTAL_STEPS = 1000  # OneCycle length; the profile takes the first steps
ROOMS = 24  # --trainer: 12 iterations of 2 scenes
PROFILED = 4  # --trainer: the epoch's last iterations, profiled
# --trainer: the first iterations, left out of the steady median: the first
# step's own costs, and the batches the prefetch thread made meanwhile
WARM = 4


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", required=True, help="directory for the tables")
    ap.add_argument("--trainer", action="store_true",
                    help="profile the trainer's epoch and validation SSI")
    ap.add_argument("--rooms", type=int, default=ROOMS,
                    help="--trainer: synthetic train rooms (two per iteration)")
    ap.add_argument("--microbatch", type=int, default=1,
                    help="micro buckets per step (1 or 2, the config's values)")
    ap.add_argument("--config", default=DEFAULT_CONFIG,
                    help="the model's config file (not with --trainer)")
    ap.add_argument("--warmup", type=int, default=3, help="untimed steps first")
    ap.add_argument("--steps", type=int, default=5, help="timed steps (median)")
    ap.add_argument("--profiled", type=int, default=2, help="steps under the profiler")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_train needs a CUDA device")
    if args.trainer:
        if args.rooms // 2 < WARM + PROFILED + 2:
            raise SystemExit(f"--rooms {args.rooms}: at least "
                             f"{2 * (WARM + PROFILED + 2)} for two steady unprofiled "
                             "iterations")
        profile_trainer(args.out, args.rooms)
        return
    conf, suffix = load_config(args.config)
    depth = conf.get("serialization_depth", 12)
    cfg = dict(conf.model)
    model = build_model(cfg, device="cuda", generator=torch.Generator().manual_seed(0))
    opt = build_optimizer(dict(conf["optimizer"]), model, dict(conf["scheduler"]),
                          total_steps=TOTAL_STEPS,
                          param_dicts=[dict(p) for p in conf.get("param_dicts", [])],
                          device="cuda")
    m = args.microbatch
    step_fn = make_train_step(model, build_model_criteria(cfg), opt, device="cuda",
                              microbatch=m)
    points = [synthetic_point_batch(conf["bucket_num_points"] // m,
                                    conf["scenes_per_device"] // m, depth=depth, seed=s,
                                    device="cuda") for s in range(m)]
    step = lambda: step_fn(points[0] if m == 1 else points)

    torch.cuda.reset_peak_memory_stats()
    res = dict(card=card_name(), config=args.config, microbatch=m,
               slots=sum(p.num_points for p in points),
               n_valid=sum(int(p.mask.sum().item()) for p in points),
               step_ms=host_ms(step, args.warmup, args.steps))
    res.update(peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               points_per_s=res["n_valid"] / (res["step_ms"] / 1e3))
    print("train " + json.dumps(res), flush=True)
    name = f"profile_train{suffix}.txt" if m == 1 else f"profile_train_micro{m}.txt"
    profile_steps(step, args.profiled, res, os.path.join(args.out, name))
    if hasattr(model.backbone, "k_neighbors"):
        profile_geometry(model.backbone, points[0], res["card"],
                         os.path.join(args.out, f"profile_geometry{suffix}.txt"))


def profile_geometry(backbone, point, card: str, path: str) -> None:
    """A kNN model's geometry alone: host ms, device ms and idle share from
    `torch.profiler` over 2 builds, and each level's kNN ms (CUDA events,
    mean of 3 after a warm-up)."""
    from cdsegnet_torch.ops.pointops import knn

    build = lambda: backbone.precompute_geometry(point)
    levels, _ = build()
    knn_ms = []
    for lv in levels[:len(backbone.enc_depths) + 1]:
        p = lv.point
        fn = lambda: knn(p.coord, p.coord, backbone.k_neighbors, p.mask, p.mask,
                         query_batch=p.batch, ref_batch=p.batch)
        fn()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(3):
            fn()
        end.record()
        end.synchronize()
        knn_ms.append(start.elapsed_time(end) / 3)
    res = dict(card=card, level_sizes=[lv.size for lv in levels],
               level_valid=[int(lv.point.mask.sum().item()) for lv in levels],
               knn_ms=knn_ms, step_ms=host_ms(build, 1, 3))
    profile_steps(build, 2, res, path)


def profile_trainer(out: str, rooms: int) -> None:
    from cdsegnet_torch.engine.hooks import HOOKS, HookBase, IterationTimer
    from cdsegnet_torch.ops.flash_attention import SOURCES
    from cdsegnet_torch.tools import train as train_tool
    from cdsegnet_torch.utils import cuda_build
    from cdsegnet_torch.utils.synthetic import room_scene

    card = card_name()
    cuda_build.build(*SOURCES)  # so that no iteration waits for nvcc
    data = os.path.join(out, "data")
    for split, seeds in (("train", range(1, rooms + 1)), ("val", (0,))):
        os.makedirs(os.path.join(data, split), exist_ok=True)
        for i, seed in enumerate(seeds):
            torch.save(room_scene(seed), os.path.join(data, split, f"scene{i:04d}_00.pth"))
    iters = []

    class TrainerProfile(HookBase):
        """Records every iteration's host clock and data wait; profiles the
        epoch's last ``PROFILED`` iterations."""

        def after_step(self):
            tr = self.trainer
            timer = next(h for h in tr.hooks if isinstance(h, IterationTimer))
            iters.append(dict(batch_s=timer.batch_m.val, data_s=timer.data_m.val))
            last = tr.steps_per_epoch - 1
            if tr.step_in_epoch == last - PROFILED:
                torch.cuda.synchronize()
                self.prof = make_profiler()
                self.prof.__enter__()
                self.t0 = time.perf_counter()
            elif tr.step_in_epoch == last:
                torch.cuda.synchronize()
                self.wall_ms = (time.perf_counter() - self.t0) * 1e3 / PROFILED
                self.prof.__exit__(None, None, None)

    HOOKS.register_module("TrainerProfile", TrainerProfile)
    hook_cfg = [dict(type="IterationTimer", warmup_iter=WARM),
                dict(type="InformationWriter", log_interval=1),
                dict(type="TrainerProfile")]
    trainer = train_tool.main([
        "--config-file", os.path.join(ROOT, "configs", "scannet", "cdsegnet.py"),
        "--options", "epoch=1", "eval_epoch=1", f"save_path={os.path.join(out, 'train')}",
        f"hooks={hook_cfg!r}", f"data.train.data_root={data}", f"data.val.data_root={data}"])
    hook = trainer.hooks[-1]
    steady = [it["batch_s"] * 1e3 for it in iters[WARM:len(iters) - PROFILED]]
    res = dict(card=card, iterations=len(iters), profiled=PROFILED,
               iter_ms=[it["batch_s"] * 1e3 for it in iters],
               data_wait_ms=[it["data_s"] * 1e3 for it in iters],
               step_ms=statistics.median(steady))
    report(hook.prof, PROFILED, hook.wall_ms, res, os.path.join(out, "profile_trainer.txt"))

    batch, _ = next(iter(trainer.val_loader))
    gen = torch.Generator(device=trainer.device).manual_seed(0)
    step = lambda: trainer.eval_step(batch, generator=gen)
    ev = dict(card=card, slots=int(batch["mask"].size), points=int(batch["mask"].sum()),
              step_ms=host_ms(step, 2, 5))
    profile_steps(step, 2, ev, os.path.join(out, "profile_eval.txt"))


if __name__ == "__main__":
    main()
