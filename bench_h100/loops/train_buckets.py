"""Training cells: the port's training step (`make_train_step`) over buckets
that cycle back to back.

The mix (kind ``train_buckets``) makes ``buckets`` static buckets of
``scenes_per_bucket`` rooms, each room through the train pipeline's
geometric part (CenterShift, GridSample at ``grid_size`` in train mode,
SphereCrop to ``points_per_scene``, CenterShift without z, NormalizeColor,
Collect), packed into ``scenes_per_bucket * points_per_scene`` slots.

Set-up builds the model and optimizer once, with weights from the seed, and
drives the first three buckets through the step with the random draws
(timesteps, noise, MSE points, curve shuffles, stochastic-depth masks)
injected from the seed: the warm-up and the compared steps in one. The
window then runs the same step on the next buckets in turn for ``seconds``.
A traced run profiles a fixed stretch of steps after the window. Once the
program's state is freed, the reference follows the three compared steps in
float32.
"""

from __future__ import annotations

import gc
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from bench_h100 import compare, counts, manifest, program, scene, traffic, weights
from bench_h100.reference import geometry as geo
from bench_h100.reference.nn import Precision
from bench_h100.reference.optim import Optimizer
from bench_h100.trace import profiled

COMPARED = 3
STRETCH_STEPS = 3


def make(mix: Dict, seed: int) -> List[Dict[str, np.ndarray]]:
    per = mix["scenes_per_bucket"]
    out = []
    for b in range(mix["buckets"]):
        scenes = []
        for s in range(per):
            i = b * per + s
            rng = traffic.rng(seed, 2, i)
            data = scene.center_shift(scene.room(traffic.room_seed(seed, i), mix["cell"]),
                                      apply_z=True)
            data = scene.grid_sample_train(data, mix["grid_size"], rng)
            data = scene.sphere_crop(data, mix["points_per_scene"], rng)
            data = scene.normalize_color(scene.center_shift(data, apply_z=False))
            scenes.append(scene.collect(data))
        out.append(scene.collate(scenes, per * mix["points_per_scene"]))
    return out


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _tensors(bucket, device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v, device=device) for k, v in bucket.items()}


def _is_stat(name: str) -> bool:
    return name.rsplit(".", 1)[-1] in ("mean", "var")


def reference_steps(cell: Dict, buckets: List[Dict[str, torch.Tensor]], scenes: int, seed: int,
                    prec: Precision, device) -> Dict:
    """The reference's losses of the compared steps, its first gradient as
    the optimizer takes it and the parameters' change after them."""
    cfg = cell["cfg"]
    R = manifest.reference(cfg)
    arch = R.Arch(cfg["model"])
    shapes = R.param_shapes(arch)
    prec.use()
    P = weights.make(shapes, traffic.derive(seed, 10), device)
    names = [n for n in shapes if not _is_stat(n)]
    start = {n: P[n].clone() for n in names}
    for n in names:
        P[n].requires_grad_(True)
    opt = Optimizer(cfg, names)
    wd = cfg["optimizer"].get("weight_decay", 0.0) if cfg["optimizer"]["type"] == "SGD" else 0.0
    losses, grad, first = [], {}, {}
    for k in range(COMPARED):
        draws = R.train_draws(arch, buckets[k], scenes, traffic.derive(seed, 20, k))
        loss = R.train_loss(arch, P, buckets[k], draws, scenes, cfg["serialization_depth"], prec)
        loss.backward()
        losses.append(float(loss.detach()))
        grads = {n: P[n].grad for n in names}
        if k == 0:
            first = {n: grads[n] + wd * P[n].detach() for n in names}
            grad = compare.leaf_norms(first)
        opt.step({n: P[n].detach() for n in names}, grads)
        for n in names:
            P[n].grad = None
        del draws, loss
    delta = {n: P[n].detach() - start[n] for n in names}
    Precision("f32").use()
    return dict(losses=losses, grad=grad, first=first, delta=delta)


def run(cell: Dict, seed: int, seconds: float, trace: bool, device, t0: float,
        fault: Optional[str] = None, control: bool = False) -> Dict:
    cfg = cell["cfg"]
    R = manifest.reference(cfg)
    arch = R.Arch(cfg["model"])
    depth = cfg["serialization_depth"]
    marks = dict(start=time.perf_counter() - t0)
    mix, buckets = traffic.make(cell["traffic"], seed)
    scenes = mix["scenes_per_bucket"]
    tb = [_tensors(b, device) for b in buckets]
    marks["inputs"] = time.perf_counter() - t0
    valid = [int(b["mask"].sum()) for b in buckets]
    if control:
        low = reference_steps(cell, tb, scenes, seed, Precision(cfg["control_precision"]), device)
        ref = reference_steps(cell, tb, scenes, seed, Precision("f32"), device)
        keep = compare.moving_elements(ref["first"])
        low["update"] = compare.masked_norms(low.pop("delta"), keep)
        ref["update"] = compare.masked_norms(ref.pop("delta"), keep)
        return dict(numbers=compare.train_numbers(low, ref), attempted=COMPARED, window=None,
                    detail=dict(losses=[low["losses"], ref["losses"]],
                                grad=compare.worst_leaves(low, ref, "grad"),
                                update=compare.worst_leaves(low, ref, "update")))

    if cfg.get("cuda_kernels") and torch.device(device).type == "cuda":
        program.build_kernels()
    marks["kernels"] = time.perf_counter() - t0
    Precision("f32").use()
    model = program.build_model(cfg, weights.make(R.param_shapes(arch), traffic.derive(seed, 10),
                                                  device), device)
    marks["model"] = time.perf_counter() - t0
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    step, opt = program.train_step(cfg, model, traffic.derive(seed, 30), device)
    fed = buckets
    if fault == "half_batch":  # one scene of each bucket left out
        fed = [dict(b, mask=b["mask"] & (b["batch"] == 0)) for b in buckets]
    if fault == "frozen":  # the update leaves the state as it was
        opt.opt.step = lambda *a, **k: None
    points = [program.to_point(b, depth, scenes, device) for b in fed]

    prog = dict(losses=[])
    gens = step.generators
    own = gens["dropout"]
    for k in range(COMPARED):
        draws = R.train_draws(arch, tb[k], scenes, traffic.derive(seed, 20, k))
        masks = draws.pop("path_masks", None)
        if masks is not None:
            gens["dropout"] = program.path_draws(masks)
        out = step(points[k], **draws)
        prog["losses"].append(float(out["loss"]))
        if k == 0:
            prog["grad"] = compare.leaf_norms(program.first_gradients(opt, cfg))
        del draws, masks, out
    gens["dropout"] = own
    # the change is judged over the elements that the reference moves,
    # known only once it has run: kept on the host meanwhile
    delta = {n: (p.detach() - start[n]).cpu() for n, p in model.named_parameters()}
    del start
    gc.collect()
    sync(device)
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

    setup_s = time.perf_counter() - t0
    steps, order = 0, []
    w0 = time.perf_counter()
    while time.perf_counter() - w0 < seconds:
        i = (COMPARED + steps) % len(points)
        step(points[i])
        order.append(i)
        steps += 1
    sync(device)
    window_s = time.perf_counter() - w0
    peak = torch.cuda.max_memory_allocated() if torch.device(device).type == "cuda" else 0

    marks["steps"] = setup_s
    run_ = dict(setup_s=setup_s, attempted=steps, cfg=cfg, phases=marks,
                window=dict(seconds=window_s, steps=steps,
                            points=sum(valid[i] for i in order), peak_bytes=peak))
    if trace:
        before = program.attention_launches()
        stretch = [(COMPARED + steps + j) % len(points) for j in range(STRETCH_STEPS)]
        with profiled(device) as held:
            for i in stretch:
                step(points[i])
        after = program.attention_launches()
        with profiled(device, host=True) as host:
            step(points[stretch[0]])
        run_.update(trace=held.trace, host_trace=host.trace)
        run_["stretch"] = dict(steps=len(stretch), host_steps=1,
                               launches={k: after[k] - before[k] for k in after})
    del step, opt, model, points, gens, own
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()

    r0 = time.perf_counter()
    ref = reference_steps(cell, tb, scenes, seed, Precision("f32"), device)
    keep = compare.moving_elements(ref["first"])
    prog["update"] = compare.masked_norms({n: d.to(device) for n, d in delta.items()}, keep)
    ref["update"] = compare.masked_norms(ref.pop("delta"), keep)
    del delta, keep
    run_["reference_s"] = time.perf_counter() - r0
    run_["numbers"] = compare.train_numbers(prog, ref)
    run_["detail"] = dict(losses=[prog["losses"], ref["losses"]],
                          grad=compare.worst_leaves(prog, ref, "grad"),
                          update=compare.worst_leaves(prog, ref, "update"))
    if trace:
        run_["per_bucket"] = [bucket_counts(R, arch, cfg, scenes, b) for b in tb]
        run_["order"] = order
        run_["stretch"]["buckets"] = stretch
    return run_


def bucket_counts(R, arch, cfg: Dict, scenes: int, bucket: Dict[str, torch.Tensor]) -> Dict:
    """The step's FLOPs (forward and backward at three forwards) and the
    attention launches' bound seconds, from the reference's pyramid."""
    levels = R.pyramid(arch, bucket, scenes, cfg["serialization_depth"])
    patch = max(arch.n_patch) if hasattr(arch, "n_patch") else None
    stats = geo.level_stats(levels, patch)
    att = (counts.attention_bounds(R.attention_calls(arch, True), stats, cfg["dtype"])
           if hasattr(R, "attention_calls") else None)
    return dict(flops=3.0 * R.forward_flops(arch, stats, True), attention=att)
