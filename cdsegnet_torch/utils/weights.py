"""Weights for the ported models: the bridge from JAX checkpoints and a seeded
initializer.

`load_jax_variables` fills a port module from the flax ``{params,
batch_stats}`` tree of the same model, given as nested dicts of numpy arrays.
It accepts all four block layouts the JAX backbone can be saved in: scanned
or unrolled (``<stage>_blocks/block`` with a leading depth axis, or
``<stage>_block{i}``) and fused or unfused (``enc_dual*``/``dec_dual*``
blocks). Flax ``Dense`` kernels ``(in, out)`` become ``nn.Linear`` weights
``(out, in)``; conv weights keep ``(K, C_in, C_out)``, and PTv2's
``grouped_weight`` (1, C) and PDNorm's per-condition ``(K, C)`` parameters
and running statistics their shapes. Loading is strict.
`load_jax_train_state` does the same from a JAX ``TrainState`` as orbax
restores it without a target (`convert_jax_checkpoint.py`).
"""

from __future__ import annotations

import math
import re
from collections.abc import Mapping
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch
from torch import nn

_BLOCK_RE = re.compile(r"(.+_block)(\d+)$")


# --- layout normalization (own copy of cdsegnet_tpu/utils/params.py) ---


def _unstack(tree: Mapping) -> Dict[str, Any]:
    """Scanned -> unrolled: ``<x>_blocks/block`` (leading depth axis) becomes
    ``<x>_block{i}``."""
    out: Dict[str, Any] = {}
    for k, v in tree.items():
        if k.endswith("_blocks") and isinstance(v, Mapping) and set(v) == {"block"}:
            depth = _leaves(v["block"])[0].shape[0]
            for i in range(depth):
                out[f"{k[:-1]}{i}"] = _map(lambda x, i=i: x[i], v["block"])
        elif isinstance(v, Mapping) and not _BLOCK_RE.fullmatch(k):
            out[k] = _unstack(v)
        else:
            out[k] = v
    return out


def _leaves(tree) -> list:
    if isinstance(tree, Mapping):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


def _map(fn, tree):
    if isinstance(tree, Mapping):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _cumshift(strides) -> list:
    out = [0]
    for s in strides:
        out.append(out[-1] + (s - 1).bit_length())
    return out


def dual_block_groups(backbone) -> list:
    """Pairing of the JAX fused schedule: which n/c stages share a pyramid
    level, their fused-group prefix and the paired depth."""
    n_shifts = _cumshift(backbone.n_stride)
    c_shifts = _cumshift(backbone.c_stride)
    cs_of = {sh: i for i, sh in enumerate(c_shifts)}
    groups = []
    for s in range(len(backbone.n_enc_depths)):
        cs = cs_of.get(n_shifts[s])
        if cs is None:
            continue
        nd, cd = backbone.n_enc_depths[s], backbone.c_enc_depths[cs]
        groups.append(dict(dual=f"enc_dual{n_shifts[s]}_block", n=f"n_enc{s}_block",
                           c=f"c_enc{cs}_block", paired=min(nd, cd), nd=nd, cd=cd))
    for s in range(len(backbone.n_enc_depths) - 1):
        cs = cs_of.get(n_shifts[s])
        if cs is None or cs >= len(backbone.c_enc_depths) - 1:
            continue
        nd, cd = backbone.n_dec_depths[s], backbone.c_dec_depths[cs]
        groups.append(dict(dual=f"dec_dual{n_shifts[s]}_block", n=f"n_dec{s}_block",
                           c=f"c_dec{cs}_block", paired=min(nd, cd), nd=nd, cd=cd))
    return groups


def _unfuse(bb: Mapping, groups) -> Dict[str, Any]:
    """Fused (DualBlock) -> unfused renaming on an unrolled backbone tree."""
    bb = dict(bb)
    for g in groups:
        paired = g["paired"]
        for i in reversed(range(g["nd"] - paired)):  # tail renumbers up
            if f"{g['n']}{i}" in bb:
                bb[f"{g['n']}{i + paired}"] = bb.pop(f"{g['n']}{i}")
        for i in reversed(range(g["cd"] - paired)):
            if f"{g['c']}{i}" in bb:
                bb[f"{g['c']}{i + paired}"] = bb.pop(f"{g['c']}{i}")
        for i in range(paired):
            d = dict(bb.pop(f"{g['dual']}{i}"))
            bb[f"{g['n']}{i}"] = {k[2:]: v for k, v in d.items() if k.startswith("n_")}
            bb[f"{g['c']}{i}"] = {k[2:]: v for k, v in d.items() if k.startswith("c_")}
    return bb


def _normalize_backbone(bb: Mapping, backbone) -> Dict[str, Any]:
    """Any of the four layouts -> unrolled, unfused."""
    bb = _unstack(bb)
    if any(k.startswith(("enc_dual", "dec_dual")) for k in bb):
        bb = _unfuse(bb, dual_block_groups(backbone))
    return bb


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Dict[Tuple[str, ...], Any]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def load_jax_variables(module: nn.Module, tree: Mapping,
                       keep: Sequence[str] = ()) -> List[str]:
    """Fill ``module`` (a port segmentor or backbone) from the JAX variables
    ``{"params": ..., "batch_stats": ...}`` of the same model.

    Strict: every leaf maps to exactly one port parameter or buffer of the
    same shape, and every port parameter and buffer but those named in
    ``keep`` is filled; otherwise it raises ``ValueError`` and leaves
    ``module`` unchanged. Returns the names in ``keep`` that the tree did
    not fill (they keep their values).
    """
    from cdsegnet_torch.models.ptv3 import PointTransformerV3

    def norm(sub: Mapping) -> Dict[str, Any]:
        if isinstance(module, PointTransformerV3):
            return _normalize_backbone(sub, module)
        sub = dict(sub)
        if "backbone" in sub and hasattr(module, "backbone"):
            sub["backbone"] = _normalize_backbone(sub["backbone"], module.backbone)
        return sub

    targets = dict(module.named_parameters())
    targets.update(module.named_buffers())
    values: Dict[str, torch.Tensor] = {}
    for collection in ("params", "batch_stats"):
        for path, leaf in _flatten(norm(tree.get(collection, {}))).items():
            arr = np.array(leaf, dtype=np.float32)
            if path[-1] == "kernel":
                path = path[:-1] + ("weight",)
                arr = arr.T
            name = ".".join(path)
            if name not in targets:
                raise ValueError(f"{collection}/{'/'.join(path)} has no "
                                 f"counterpart in {type(module).__name__}")
            if name in values:
                raise ValueError(f"{name} is filled twice")
            if tuple(arr.shape) != tuple(targets[name].shape):
                raise ValueError(f"{name}: shape {arr.shape} != "
                                 f"{tuple(targets[name].shape)}")
            values[name] = torch.from_numpy(np.ascontiguousarray(arr).reshape(arr.shape))
    missing = sorted(set(targets) - set(values) - set(keep))
    if missing:
        raise ValueError(f"not filled from the JAX tree: {missing}")
    with torch.no_grad():
        for name, val in values.items():
            targets[name].copy_(val)
    return sorted(set(keep) - set(values))


# the timestep MLP and each c-block's projection of its embedding
_T_MLP = re.compile(r"backbone\.(fc_t[12]|[^.]+_block\d+\.t_mlp)\.")


def load_jax_train_state(module: nn.Module, raw: Mapping) -> Tuple[int, List[str]]:
    """Fill ``module`` from a JAX ``TrainState`` tree (``params``,
    ``batch_stats``, ``step``; the optimizer state is not read) and return
    ``(step, kept)``.

    Strict as `load_jax_variables`, with one exception: a Baseline
    (`CNFSegmentor` with ``dm=False``) trained by JAX has no timestep MLP
    (``fc_t1``, ``fc_t2``) and no c-block ``t_mlp``, because JAX initialises
    through the training forward, which embeds no timestep when ``dm=False``
    (ROADMAP Queue 3). Those tensors of the port then keep the values
    ``module`` holds (the port's seeded initializer when `build_model` made
    it); their names are returned in ``kept``. Only SSI reads them, at
    t = 0; no training step does.
    """
    from cdsegnet_torch.models.segmentor import CNFSegmentor

    keep: List[str] = []
    if isinstance(module, CNFSegmentor) and not module.dm:
        keep = [n for n, _ in module.named_parameters() if _T_MLP.match(n)]
    kept = load_jax_variables(module, dict(params=raw["params"],
                                           batch_stats=raw.get("batch_stats", {})),
                              keep=keep)
    return int(np.asarray(raw["step"])), kept


def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Draw weights from the same families as the flax initializers:
    ``lecun_normal`` for Dense kernels and zeros for biases;
    ``variance_scaling(1, fan_in, uniform)`` for (K, C_in, C_out) conv
    weights and the Restomer's depthwise (3, 1, C) ones; ones and zeros for
    norms; ``lecun_normal`` over the fan-in ``c`` for CAC's raw ``(c, cls)``
    ``seg_head_kernel``; a truncated normal of std 0.02 for the RPE table
    and Swin3D's ``(3, 2L, H, D)`` cRSE tables;
    ``variance_scaling(1, fan_in, uniform)`` for OctFormer's ``(27, C)``
    ``dw_weight`` (fan-in 27); ones for the
    Restomer's temperature; ones (0.5 for the ``b_`` gates) for a transfer
    gate's ``feat_scale``; ``variance_scaling(1/3, fan_in, uniform)`` for
    PTv2's (1, C) ``grouped_weight`` (fan-in 1: uniform in [-1, 1]); for
    PPT a normal of std 1 for the ``embedding_table``, of std 0.02 for the
    learned ``class_embedding``, and ln(1 / 0.07) for ``logit_scale``; a
    truncated normal of std 0.02 for MSC's ``mask_token``; running mean 0
    and variance 1, per condition for PDNorm."""
    from cdsegnet_torch.models.modules import (
        Dense, LayerNorm, MaskedBatchNorm, PDMaskedBatchNorm)

    with torch.no_grad():
        for name, p in module.named_parameters():
            owner = module.get_submodule(name.rsplit(".", 1)[0]) if "." in name else module
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "embedding_table":  # PPT's dataset context, normal(1)
                nn.init.normal_(p, 0.0, 1.0, generator=generator)
            elif leaf == "class_embedding":  # PPT's learned class table, normal(0.02)
                nn.init.normal_(p, 0.0, 0.02, generator=generator)
            elif leaf == "logit_scale":  # PPT's temperature, ln(1 / 0.07)
                p.fill_(math.log(1.0 / 0.07))
            elif leaf == "mask_token":  # MSC's, truncated normal of std 0.02
                nn.init.trunc_normal_(p, 0.0, 0.02, -0.04, 0.04, generator=generator)
            elif leaf.endswith("_table"):  # RPE and Swin3D's cRSE tables
                nn.init.trunc_normal_(p, 0.0, 0.02, -0.04, 0.04, generator=generator)
            elif leaf == "dw_weight":  # OctFormer's depthwise (27, C), fan-in 27
                lim = math.sqrt(3.0 / p.shape[0])
                nn.init.uniform_(p, -lim, lim, generator=generator)
            elif leaf == "temperature":
                p.fill_(1.0)
            elif leaf == "feat_scale":
                p.fill_(0.5 if owner.tm_feat.startswith("b_") else 1.0)
            elif isinstance(owner, Dense) and leaf == "weight":
                # flax lecun_normal: truncated normal at +-2 std, rescaled
                std = math.sqrt(1.0 / p.shape[1]) / 0.87962566103423978
                nn.init.trunc_normal_(p, 0.0, std, -2 * std, 2 * std,
                                      generator=generator)
            elif leaf == "seg_head_kernel":  # CAC's raw (c, cls) head, lecun_normal
                std = math.sqrt(1.0 / p.shape[0]) / 0.87962566103423978
                nn.init.trunc_normal_(p, 0.0, std, -2 * std, 2 * std,
                                      generator=generator)
            elif leaf == "grouped_weight":
                nn.init.uniform_(p, -1.0, 1.0, generator=generator)
            elif p.dim() == 3:  # conv weight (K, C_in, C_out)
                lim = math.sqrt(3.0 / (p.shape[0] * p.shape[1]))
                nn.init.uniform_(p, -lim, lim, generator=generator)
            elif (isinstance(owner, (LayerNorm, MaskedBatchNorm, PDMaskedBatchNorm))
                  and leaf == "scale"):
                p.fill_(1.0)
            elif leaf in ("bias", "seg_head_bias"):
                p.zero_()
            else:
                raise ValueError(f"no initializer for parameter {name}")
        for name, b in module.named_buffers():
            b.fill_(1.0 if name.endswith("var") else 0.0)
