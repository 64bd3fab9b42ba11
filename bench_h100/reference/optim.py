"""The optimizer updates and the one-cycle schedule, written out.

AdamW (decoupled decay, bias-corrected moments) and SGD with Nesterov
momentum and coupled decay, each over keyword groups that set their own peak
learning rate; the one-cycle cosine schedule warms up from ``lr /
div_factor`` over ``int(total * pct_start)`` updates and anneals to that
value over ``final_div_factor``, computed in float32.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

_F = np.float32


def onecycle(max_lr: float, total: int, pct_start: float, div_factor: float,
             final_div_factor: float, step: int) -> float:
    initial = max_lr / div_factor
    final = initial / final_div_factor
    up = max(int(total * pct_start), 1)
    down = max(total - up, 1)
    s = _F(step)
    if s < up:
        f = _F(0.5) * (_F(1) + np.cos(_F(math.pi) * (_F(1) - np.clip(s / _F(up), _F(0), _F(1)))))
        return float(_F(initial) + _F(max_lr - initial) * f)
    t = np.clip((s - _F(up)) / _F(down), _F(0), _F(1))
    return float(_F(final) + _F(max_lr - final) * (_F(0.5) * (_F(1) + np.cos(_F(math.pi) * t))))


class Optimizer:
    """The update of ``cfg["optimizer"]`` with ``cfg["scheduler"]`` over
    ``cfg["param_dicts"]`` keyword groups, for named float32 parameters."""

    def __init__(self, cfg: Dict, names: List[str]):
        self.opt, self.sched = cfg["optimizer"], cfg["scheduler"]
        self.total = cfg["total_steps"]
        self.groups = cfg.get("param_dicts", [])
        self.state: Dict[str, Dict[str, torch.Tensor]] = {}
        self.count = 0
        self.names = names

    def lr(self, name: str) -> float:
        peak = self.opt["lr"]
        for g in self.groups:
            if g["keyword"] in name:
                peak = g["lr"]
                break
        s = self.sched
        return onecycle(peak, self.total, s["pct_start"], s["div_factor"],
                        s["final_div_factor"], self.count)

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor]) -> None:
        kind, wd = self.opt["type"], self.opt.get("weight_decay", 0.0)
        for name in self.names:
            p, g, lr = params[name], grads[name], self.lr(name)
            st = self.state.setdefault(name, {})
            if kind == "AdamW":
                b1, b2 = self.opt.get("betas", (0.9, 0.999))
                m = st.setdefault("m", torch.zeros_like(p))
                v = st.setdefault("v", torch.zeros_like(p))
                t = self.count + 1
                p.mul_(1.0 - lr * wd)
                m.mul_(b1).add_(g, alpha=1.0 - b1)
                v.mul_(b2).addcmul_(g, g, value=1.0 - b2)
                denom = (v.sqrt() / math.sqrt(1.0 - b2 ** t)).add_(1e-8)
                p.addcdiv_(m, denom, value=-lr / (1.0 - b1 ** t))
            elif kind == "SGD":
                mom = self.opt.get("momentum", 0.9)
                d = g + wd * p
                buf = st.get("buf")
                buf = d.clone() if buf is None else buf.mul_(mom).add_(d)
                st["buf"] = buf
                p.sub_(lr * (d + mom * buf if self.opt.get("nesterov") else buf))
            else:
                raise NotImplementedError(kind)
        self.count += 1
