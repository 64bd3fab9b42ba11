"""The training and evaluation steps.

Port of `make_train_step` and `make_eval_step` in
`cdsegnet_tpu/engine/state.py`. The training step: forward in training
mode, the loss and backward on each micro bucket, the mean over the ranks
of a process group (`parallel.dist`, in place of JAX's `pmean` over the
mesh), then the optimizer update (keyword clip, AdamW, SGD or Adam with
per-group schedules). The model and the optimizer hold the state that JAX's
``TrainState`` carries (the parameters and running statistics; the moments
and the update count). Three generators per rank, seeded once, take the
place of the step's rng split, into which JAX folds the device index:
dropout and diffusion on the device, shuffle on the CPU. Both steps are
generic over the model's output dict (the CNF and ablation segmentors, plain
PTv3 and PTv2, and `DefaultClassifier`, whose ``n_pred`` and ``n_target``
are per scene; a model without ``pyramid_dropped`` reports no drops), and
pass ``model_kwargs`` to the forward (PPT's ``condition``, a plain Python
int). `make_msc_train_step` is the same step over MSC's two views, whose
model gives its own loss. The evaluation step is SSI in eval mode (the
model's ``inference``: `CNFSegmentor`'s or an ablation segmentor's), or the
plain forward's logits. `batch_to_point` turns a collated numpy batch into
a `PointBatch`, `msc_inputs` a collated view pair into MSC's inputs.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Union

import numpy as np
import torch

from cdsegnet_torch.engine.optimizer import KeywordOptimizer
from cdsegnet_torch.models.losses import Criteria
from cdsegnet_torch.models.structure import PointBatch, make_point_batch
from cdsegnet_torch.parallel import dist
from cdsegnet_torch.utils.device import resolve_device


def batch_to_point(batch: Dict[str, np.ndarray], depth: int, num_scenes: int,
                   device: Optional[Union[str, torch.device]] = None) -> PointBatch:
    """A collated batch (`data.collate.collate_scenes`) as a `PointBatch` on
    ``device`` (the GPU unless the caller names another), with its instance
    ids and centroids when it has them."""
    return make_point_batch(
        coord=batch["coord"], feat=batch["feat"], grid_coord=batch["grid_coord"],
        batch=batch["batch"], mask=batch["mask"], segment=batch.get("segment"),
        instance=batch.get("instance"), instance_centroid=batch.get("instance_centroid"),
        depth=depth, num_scenes=num_scenes, device=device)


def msc_inputs(batch: Dict[str, np.ndarray], depth: int, num_scenes: int,
               device: Optional[Union[str, torch.device]] = None,
               feat_keys: Sequence[str] = ("color", "normal")) -> Dict[str, object]:
    """A collated view pair (`data.collate.collate_pair_scenes`) as the
    keyword inputs of `models.msc.MaskedSceneContrast`: each view's
    `PointBatch`, origin coordinates and reconstruction targets, on
    ``device`` (the GPU unless the caller names another)."""
    device = resolve_device(device)
    out: Dict[str, object] = {}
    for v in ("view1", "view2"):
        sub = {k[len(v) + 1:]: a for k, a in batch.items() if k.startswith(v + "_")}
        out[v] = batch_to_point(sub, depth, num_scenes, device)
        out[f"{v}_origin_coord"] = torch.as_tensor(sub["origin_coord"], device=device)
        out[f"{v}_target"] = {k: torch.as_tensor(sub["target_" + k], device=device)
                              for k in feat_keys}
    return out


def rank_seed(seed: int, rank: int) -> int:
    """The seed of rank ``rank``'s generators: ``seed`` itself on rank 0 (so
    one process draws what it always drew), a 62-bit seed from numpy's
    `SeedSequence` of ``(seed, rank)`` on the others."""
    if rank == 0:
        return seed
    return int(np.random.SeedSequence((seed, rank)).generate_state(1, np.uint64)[0] >> 2)


def make_generators(seed: int, device: torch.device,
                    rank: int = 0) -> Dict[str, torch.Generator]:
    """The step's generators of rank ``rank``: ``dropout`` and ``diffusion``
    on ``device``, ``shuffle`` on the CPU, each seeded from `rank_seed`."""
    s = rank_seed(seed, rank)
    return dict(dropout=torch.Generator(device).manual_seed(s),
                diffusion=torch.Generator(device).manual_seed(s + 1),
                shuffle=torch.Generator().manual_seed(s + 2))


def _rank_mean_(model: torch.nn.Module, loss: torch.Tensor, microbatch: int) -> None:
    """Average over the ranks, in place, as JAX's `pmean`s do: the gradients
    (summed over ``microbatch`` micros; a parameter without a gradient on
    every rank keeps none, one without a gradient on some ranks counts zero
    there), the running statistics and ``loss``. One collective."""
    world = dist.world_size()
    params = [p for p in model.parameters() if p.requires_grad]
    has = torch.tensor([float(p.grad is not None) for p in params], device=loss.device)
    grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
    stats = [b for b in model.buffers() if b.is_floating_point()]
    dist.flat_all_reduce_(grads + stats + [has, loss])
    for p, g, h in zip(params, grads, has.tolist()):
        p.grad = g.div_(microbatch * world) if h else None
    for b in stats:
        b.div_(world)
    loss.div_(world)


MSC_METRICS = ("nce_loss", "pos_sim", "neg_sim")


def make_train_step(model: torch.nn.Module, criteria: Criteria,
                    optimizer: KeywordOptimizer, seed: int = 0,
                    device: Optional[Union[str, torch.device]] = None,
                    microbatch: int = 1, model_kwargs: Optional[Dict] = None,
                    generators: Optional[Dict[str, torch.Generator]] = None
                    ) -> Callable[..., Dict]:
    """The step ``step(point, **inject) -> metrics`` on ``device`` (the GPU
    unless the caller names another; raises without one). It draws from
    ``step.generators`` (`make_generators` of ``seed`` and this process's
    rank, or ``generators`` when given: steps that share them draw from one
    stream), which a checkpoint saves and a resume restores.

    ``microbatch`` > 1: ``point`` is a sequence of that many micro buckets,
    trained in turn (JAX's `_grads_micro`): the running statistics carry
    from one micro to the next, the gradients are summed and divided by
    ``microbatch``, the loss is the micros' mean, and ``valid_points`` and
    the drops are summed. In a process group of more than one rank the
    gradients, the loss and the running statistics are then averaged over
    the ranks (JAX's `pmean` over the mesh) before the keyword clip and
    the optimizer; the batch statistics inside each forward stay the rank's own.

    ``model_kwargs`` go to every forward (PPT's ``condition``); ``inject``
    goes to the model's forward (``ts_scene``, ``noise``, ``mse_valid`` and
    ``perms`` replace the draws); with micros each value is a sequence, one
    per micro. A bucket is a `PointBatch`, or a dict of the forward's
    keyword inputs (`msc_inputs`; ``valid_points`` counts its ``view1``).
    A model with ``zero_unused_grads`` (PPT) gets a zero gradient for every
    parameter its forward left unused, as JAX's step gives, so that the
    optimizer decays and counts it as optax does. The metrics are ``loss``
    (a 0-d tensor, detached), ``valid_points`` (a 0-d tensor),
    ``dropped_l1``, ..., one per pooled level: the valid points it lost to
    overflow, and MSC's ``nce_loss``, ``pos_sim`` and ``neg_sim`` when the
    model gives them (detached; of the last micro).
    """
    model_kwargs = dict(model_kwargs or {})
    device = resolve_device(device)
    if microbatch < 1:
        raise ValueError(f"microbatch={microbatch}")
    if generators is None:
        generators = make_generators(seed, device, dist.rank())
    world = dist.world_size()

    def forward(pt, inj):
        if isinstance(pt, PointBatch):
            return model(pt, generators=generators, **model_kwargs, **inj)
        return model(**pt, generators=generators, **model_kwargs, **inj)

    def step(point: Union[PointBatch, Dict, Sequence[PointBatch]], **inject) -> Dict:
        micros = [point] if isinstance(point, (PointBatch, dict)) else list(point)
        if len(micros) != microbatch:
            raise ValueError(f"{len(micros)} micro buckets for microbatch={microbatch}")
        injects = ([inject] if microbatch == 1 else
                   [{k: v[i] for k, v in inject.items()} for i in range(microbatch)])
        model.train()
        optimizer.zero_grad()
        losses, drops = [], []
        for pt, inj in zip(micros, injects):
            out = forward(pt, inj)
            loss = criteria(out, mode="train")
            loss.backward()
            losses.append(loss.detach())
            drops.append(out.get("pyramid_dropped", ()))
        if getattr(model, "zero_unused_grads", False):
            for p in model.parameters():
                if p.requires_grad and p.grad is None:
                    p.grad = torch.zeros_like(p)
        loss = losses[0] if microbatch == 1 else torch.stack(losses).mean()
        if world > 1:
            _rank_mean_(model, loss, microbatch)
        elif microbatch > 1:
            for p in model.parameters():
                if p.grad is not None:
                    p.grad.div_(microbatch)
        optimizer.step()
        metrics = dict(loss=loss, valid_points=sum(
            (pt if isinstance(pt, PointBatch) else pt["view1"]).mask.sum() for pt in micros))
        for i, d in enumerate(zip(*drops)):
            metrics[f"dropped_l{i + 1}"] = sum(d)
        for k in MSC_METRICS:
            if k in out:
                metrics[k] = out[k].detach()
        return metrics

    step.generators = generators
    return step


def make_msc_train_step(model: torch.nn.Module, criteria: Criteria,
                        optimizer: KeywordOptimizer, seed: int = 0,
                        device: Optional[Union[str, torch.device]] = None
                        ) -> Callable[..., Dict]:
    """The MSC pretraining step (JAX's `make_msc_train_step`): `make_train_step`
    over `msc_inputs` buckets with no microbatch; the model gives its own
    ``loss`` (no criteria term applies), and ``nce_loss``, ``pos_sim`` and
    ``neg_sim`` join ``loss`` and ``valid_points`` (view 1's).
    ``step(inputs, seed=, score=)`` injects the hash seed and the pair
    scores."""
    return make_train_step(model, criteria, optimizer, seed=seed, device=device)


def make_eval_step(model: torch.nn.Module, depth: int, num_scenes: int,
                   device: Optional[Union[str, torch.device]] = None,
                   model_kwargs: Optional[Dict] = None) -> Callable[..., Dict]:
    """The step ``step(batch, generator=None, noise=None) -> dict(seg_logits)``
    on ``device`` (the GPU unless the caller names another; raises without
    one): a collated batch through SSI in eval mode, without gradients. A
    model with an ``inference`` method (`CNFSegmentor`, the ablation
    segmentors) runs it, drawing its noise from ``generator`` unless
    ``noise`` is given; other models evaluate through the plain forward and
    give its outputs, with ``n_pred`` as ``seg_logits`` (a classifier's
    per-scene logits beside its ``cls_pred``); one that draws its own noise
    in evaluation (`models.ppt.PointPromptTraining`, which has
    ``draw_ssi_noise``) takes ``noise``, or draws from ``generator``.
    ``model_kwargs`` go to the forward (PPT's ``condition``)."""
    device = resolve_device(device)
    has_inference = hasattr(type(model), "inference")
    draws = hasattr(model, "draw_ssi_noise")
    model_kwargs = dict(model_kwargs or {})

    @torch.no_grad()
    def step(batch: Dict[str, np.ndarray], generator: Optional[torch.Generator] = None,
             noise: Optional[torch.Tensor] = None) -> Dict:
        model.eval()
        point = batch_to_point(batch, depth, num_scenes, device)
        if has_inference:
            return model.inference(point, noise=noise, generator=generator, **model_kwargs)
        kwargs = dict(model_kwargs)
        if draws:
            kwargs.update(noise=noise, generators=dict(diffusion=generator))
        out = model(point, **kwargs)
        return dict(out, seg_logits=out.get("seg_logits", out.get("n_pred")))

    return step
