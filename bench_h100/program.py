"""What the benchmark takes from the system under test, the PyTorch port
``cdsegnet_torch``: its model factory, training step, optimizer, losses,
tester and attention kernel counters. Nothing else of the harness imports
the port.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def build_model(cfg: Dict, weights: Dict[str, torch.Tensor], device) -> torch.nn.Module:
    """The port's model of ``cfg["model"]``, built on ``device`` and loaded
    with ``weights`` (every parameter and statistic, by name)."""
    from cdsegnet_torch.models import builder

    with torch.device(device):
        model = builder._build(dict(cfg["model"]))
    model.load_state_dict(weights, strict=True)
    return model


def train_step(cfg: Dict, model: torch.nn.Module, seed: int, device):
    """``(step, optimizer)``: the port's `make_train_step` with its losses
    and optimizer (keyword groups, one-cycle schedule)."""
    from cdsegnet_torch.engine.optimizer import build_optimizer
    from cdsegnet_torch.engine.state import make_train_step
    from cdsegnet_torch.models.builder import build_model_criteria

    opt = build_optimizer(dict(cfg["optimizer"]), model, dict(cfg["scheduler"]),
                          total_steps=cfg["total_steps"], param_dicts=cfg["param_dicts"],
                          device=device)
    step = make_train_step(model, build_model_criteria(dict(cfg["model"])), opt, seed=seed,
                           device=device)
    return step, opt


def to_point(bucket: Dict[str, np.ndarray], depth: int, num_scenes: int, device):
    from cdsegnet_torch.engine.state import batch_to_point

    return batch_to_point(bucket, depth, num_scenes, device)


def path_draws(masks):
    """Stochastic-depth keep masks handed to the port in call order."""
    from cdsegnet_torch.models.modules import DropoutDraws

    return DropoutDraws(None, [], path_masks=list(masks))


def moment_name(opt) -> str:
    return "exp_avg" if opt.kind in ("AdamW", "Adam") else "momentum_buffer"


def first_gradients(opt, cfg: Dict) -> Dict[str, torch.Tensor]:
    """Each parameter's gradient as the optimizer took it in its first
    update, worked out from its state: Adam's first moment over (1 - beta1);
    SGD's momentum buffer is the gradient plus the coupled decay."""
    key = moment_name(opt)
    b1 = cfg["optimizer"].get("betas", (0.9, 0.999))[0]
    out = {}
    for name, p in opt.named_params:
        st = opt.opt.state.get(p, {})
        if key not in st:
            out[name] = None
            continue
        out[name] = st[key] / (1.0 - b1) if key == "exp_avg" else st[key].clone()
    return out


def tester(cfg: Dict, model: torch.nn.Module, device):
    from cdsegnet_torch.engine.test import SemSegTester

    return SemSegTester(dict(num_devices=1, serialization_depth=cfg["serialization_depth"],
                             seed=cfg["seed"], save_path=".", test_buckets=cfg["test_buckets"]),
                        model=model, device=device, verbose=False)


def attention_launches() -> Dict[str, int]:
    from cdsegnet_torch.ops import flash_attention as fa

    return dict(fwd=fa.patch_attention_fwd.launches, dq=fa.patch_attention_bwd_dq.launches,
                dkdv=fa.patch_attention_bwd_dkdv.launches)


def build_kernels() -> None:
    """Compile the port's CUDA sources (once per checkout)."""
    from cdsegnet_torch.ops.flash_attention import SOURCES
    from cdsegnet_torch.utils.cuda_build import build

    build(*SOURCES)
