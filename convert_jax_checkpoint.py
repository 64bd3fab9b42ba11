#!/usr/bin/env python3
"""Convert a training checkpoint of the JAX package into one the PyTorch port loads.

Usage:
    python convert_jax_checkpoint.py --config-file configs/scannet/cdsegnet.py \
        --jax-checkpoint exp/scannet/model/model_best \
        --output exp/scannet_port/model/model_best

It restores the orbax ``TrainState`` directory that the JAX package's
`CheckpointManager` wrote, with ``StandardCheckpointer().restore(path)``
and no target (the call of that manager's ``restore_raw``), builds the
config's model in the port on the CPU, fills it with
`cdsegnet_torch.utils.weights.load_jax_train_state` (any of the JAX
package's parameter layouts; strict), and writes ``snapshot(model, step)``
with the port's `CheckpointManager` as ``--output``.

The optimizer's state is not carried (optax's and the port's AdamW moments
and SGD momentum buffers differ in layout), so the file loads as weights: for the tester
(``tools/test.py --checkpoint``) or for fine-tuning (``weight=`` in the
trainer's config), not as a run to resume (``resume=True``). A Baseline
(``dm=False``) trained by JAX has no ``fc_t1``/``fc_t2``: the port's seeded
initializer fills them, and the script names them. Every model type the
port builds converts the same way, the ablation segmentors (③–⑥, DM) and
the PTv3 options (RPE tables, the Restomer's depthwise convs and
temperature, the transfer gates, ``cross_block1``), PTv2 (m1's
``grouped_weight``, m3's per-condition PDNorm tensors and ``modulation``),
`DefaultClassifier`, the sparse-conv family (SpUNet and its variants,
OA-CNNs, SPVCNN, CAC with its raw ``seg_head_kernel``, PointGroup), PTv1
(PT-v1, Seg26/38/50) and the window-attention family (OctFormer's
``dw_weight`` and RPE tables, Stratified's ``kv_coarse`` and RPE tables,
Swin3D's cRSE ``query/key/value_{xyz,rgb,norm}_table``), MSC
(``mask_token``, ``color_head``, ``normal_head``) and PPT (v1m1's
``embedding_table``, learned ``class_embedding``, ``proj_head`` and
``logit_scale``; v1m2's ``seg_head{i}``; a ``class_embedding_path`` table
is read from its ``.npy`` at build, not from the checkpoint)
included: the bridge maps each tensor by its flax
name, so the script needs nothing per type.

This script imports orbax, and through it JAX: run it where orbax is
installed. Nothing in ``cdsegnet_torch/`` or ``chip_smoke.py`` imports it;
the machine that runs the port needs only the file it writes.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Dict, List, Optional

ROOT = os.path.dirname(os.path.abspath(__file__))


def convert(config_file: str, jax_checkpoint: str, output: str) -> Dict:
    """Convert ``jax_checkpoint`` for the model of ``config_file`` into the
    port checkpoint ``output``; returns its step and the names of the
    tensors the port's initializer filled."""
    import orbax.checkpoint as ocp
    import torch

    from cdsegnet_torch.engine.checkpoint import CheckpointManager, snapshot
    from cdsegnet_torch.engine.config import Config
    from cdsegnet_torch.models.builder import build_model
    from cdsegnet_torch.utils.weights import load_jax_train_state

    path = os.path.abspath(jax_checkpoint)
    if not os.path.isdir(path):
        raise FileNotFoundError(f"no orbax checkpoint at {path}")
    raw = ocp.StandardCheckpointer().restore(path)
    cfg = Config.fromfile(config_file)
    model = build_model(dict(cfg.model), device="cpu",
                        generator=torch.Generator().manual_seed(cfg.get("seed") or 0))
    step, kept = load_jax_train_state(model, raw)
    output = os.path.abspath(output)
    CheckpointManager(os.path.dirname(output)).save(snapshot(model, step),
                                                    os.path.basename(output))
    return dict(step=step, kept=kept, output=output)


def main(argv: Optional[List[str]] = None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config-file", required=True)
    ap.add_argument("--jax-checkpoint", required=True,
                    help="an orbax TrainState directory written by the JAX package")
    ap.add_argument("--output", required=True, help="the port checkpoint file to write")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    out = convert(args.config_file, args.jax_checkpoint, args.output)
    print(f"step {out['step']} -> {out['output']}")
    for name in out["kept"]:
        print(f"not in the JAX checkpoint, kept from the port's initializer: {name}")
    return out


if __name__ == "__main__":
    main()
