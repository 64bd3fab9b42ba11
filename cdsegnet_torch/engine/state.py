"""The training and evaluation steps.

Port of `make_train_step` and `make_eval_step` in
`cdsegnet_tpu/engine/state.py` for one device and one microbatch. The
training step: forward in training mode, the loss, backward, then the
optimizer update (keyword clip, AdamW with per-group schedules). The model
and the optimizer hold the state that JAX's ``TrainState`` carries (the
parameters and running statistics; the moments and the update count). Three
generators, seeded once, take the place of the step's rng split: dropout
and diffusion on the device, shuffle on the CPU. The evaluation step is
SSI in eval mode (`CNFSegmentor.inference`), or the plain forward's logits.
Microbatch accumulation and a device mesh are not ported and raise
`NotImplementedError`. `batch_to_point` turns a collated numpy batch into a
`PointBatch`.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Union

import numpy as np
import torch

from cdsegnet_torch.engine.optimizer import KeywordAdamW
from cdsegnet_torch.models.losses import Criteria
from cdsegnet_torch.models.structure import PointBatch, make_point_batch
from cdsegnet_torch.utils.device import resolve_device


def batch_to_point(batch: Dict[str, np.ndarray], depth: int, num_scenes: int,
                   device: Optional[Union[str, torch.device]] = None) -> PointBatch:
    """A collated batch (`data.collate.collate_scenes`) as a `PointBatch` on
    ``device`` (the GPU unless the caller names another)."""
    return make_point_batch(
        coord=batch["coord"], feat=batch["feat"], grid_coord=batch["grid_coord"],
        batch=batch["batch"], mask=batch["mask"], segment=batch.get("segment"),
        depth=depth, num_scenes=num_scenes, device=device)


def make_generators(seed: int, device: torch.device) -> Dict[str, torch.Generator]:
    """The step's generators: ``dropout`` and ``diffusion`` on ``device``,
    ``shuffle`` on the CPU, each seeded from ``seed``."""
    return dict(dropout=torch.Generator(device).manual_seed(seed),
                diffusion=torch.Generator(device).manual_seed(seed + 1),
                shuffle=torch.Generator().manual_seed(seed + 2))


def make_train_step(model: torch.nn.Module, criteria: Criteria,
                    optimizer: KeywordAdamW, seed: int = 0,
                    device: Optional[Union[str, torch.device]] = None,
                    microbatch: int = 1, mesh=None) -> Callable[..., Dict]:
    """The step ``step(point, **inject) -> metrics`` on ``device`` (the GPU
    unless the caller names another; raises without one). It draws from
    ``step.generators`` (`make_generators` of ``seed``), which a checkpoint
    saves and a resume restores.

    ``inject`` goes to the model's forward (``ts_scene``, ``noise``,
    ``mse_valid`` and ``perms`` replace the draws). The metrics are ``loss`` (a 0-d
    tensor, detached), ``valid_points`` (a 0-d tensor) and ``dropped_l1``,
    ..., one per pooled level: the valid points it lost to overflow.
    """
    device = resolve_device(device)
    if microbatch != 1:
        raise NotImplementedError("microbatch accumulation is not ported")
    if mesh is not None:
        raise NotImplementedError("a device mesh (data parallelism) is not ported")
    generators = make_generators(seed, device)

    def step(point: PointBatch, **inject) -> Dict:
        model.train()
        optimizer.zero_grad()
        out = model(point, generators=generators, **inject)
        loss = criteria(out, mode="train")
        loss.backward()
        optimizer.step()
        metrics = dict(loss=loss.detach(), valid_points=point.mask.sum())
        for i, d in enumerate(out.get("pyramid_dropped", ())):
            metrics[f"dropped_l{i + 1}"] = d
        return metrics

    step.generators = generators
    return step


def make_eval_step(model: torch.nn.Module, depth: int, num_scenes: int,
                   device: Optional[Union[str, torch.device]] = None
                   ) -> Callable[..., Dict]:
    """The step ``step(batch, generator=None, noise=None) -> dict(seg_logits)``
    on ``device`` (the GPU unless the caller names another; raises without
    one): a collated batch through SSI in eval mode, without gradients. A
    `CNFSegmentor` draws its c-branch noise from ``generator`` unless
    ``noise`` is given; other models evaluate through the plain forward and
    give its ``n_pred`` as ``seg_logits``."""
    device = resolve_device(device)
    has_inference = hasattr(type(model), "inference")

    @torch.no_grad()
    def step(batch: Dict[str, np.ndarray], generator: Optional[torch.Generator] = None,
             noise: Optional[torch.Tensor] = None) -> Dict:
        model.eval()
        point = batch_to_point(batch, depth, num_scenes, device)
        if has_inference:
            return model.inference(point, noise=noise, generator=generator)
        return dict(seg_logits=model(point)["n_pred"])

    return step
