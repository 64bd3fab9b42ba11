#!/usr/bin/env python3
"""Drive the PyTorch port (`cdsegnet_torch`) on one NVIDIA GPU and check it.

Run from the root of a checkout, with no arguments: ``python3 chip_smoke.py``.
Phases, each fatal on failure:

1. card: the GPU's name and power limit, as nvidia-smi reports them;
2. build: compile every kernel source from the checkout (one nvcc per
   source, all started together), print each kernel's registers and spills
   (none allowed) and count of tensor-core instructions (HMMA, from
   cuobjdump; the bf16 forward, dq and dk/dv kernels must have some);
3. kernels: the forward kernel against its plain PyTorch version on the
   GPU, at every shape the SSI path gives it, at every shape a tester
   fragment of the 131,072-slot bucket gives it (the first fragment of
   phase 8's scene, and there the DDIM c-decoder's launches in eval mode), at
   every shape the trainer's validation SSI gives it (phase 8's room in the
   evaluator's 524,288-slot bucket), at the timing protocol's whole-scene
   fragments (a room of about 200,000 points in the 262,144-slot bucket and
   phase 8's room in the 524,288-slot one, depth 12) and at the nuScenes
   sweep's SSI shapes (32,768 slots), in bf16 and f32, plus padded
   multi-scene batches;
   every output row must be finite, and a second run bit-equal to the
   first. Times (CUDA events) beside the bound and the time of the
   equivalent library call;
4. ssi: CDSegNet single-step inference at the full width of
   `configs/scannet/cdsegnet.py` (random weights from a seed) on a
   104,448-point synthetic scene: launches counted, checked against the
   plain attention route (as shipped, with the softmax in f32 on both routes,
   and with the whole model in f32), and timed (3 warm-ups, median of 10);
5. train kernels: the forward kernel with its log-sum-exp and the two
   backward kernels against autograd through the plain version, at every
   shape the training step gives them (on each level's real scene ids and
   validity, g zero on invalid rows), in bf16 and f32, timed beside their
   bounds, the plain version and `scaled_dot_product_attention`; then
   boundary layouts (scenes and patches that cut the kernels' tiles at odd
   offsets, padding rows, D = 32), the nuScenes training batch's shapes and
   phase 13's micro bucket (102,400 slots, one scene) (bf16 timed, f32
   checked); every forward and backward run twice, bit-equal;
6. train: the CNF training step of the same config at its bucket (2 scenes,
   204,800 slots, serialization depth 12; bf16, shuffled curves, drop_path
   0.3, MSE subsampling, GLS, AdamW + OneCycle with the "block" group):
   launches per step counted, loss, gradients, drops, running statistics
   and both parameter groups checked; timed (3 warm-ups, median of 5);
7. train route gap: one step's loss and gradients through the kernels
   against the plain attention route on one 32,768-slot scene, in f32 and
   as shipped (bf16);
8. test: the TTA fragment-voting tester through its CLI entry point
   (`cdsegnet_torch.tools.test.main`) at the same full width, on a
   synthetic room of about 260,000 points written as a ScanNet scene, with
   a checkpoint saved by the port's `CheckpointManager`: the shipped test
   pipeline (13 augmentations, 2 cm test-mode grid sampling, depth 12,
   seed 54421566). Every fragment must take 32 kernel launches, no plain
   attention and give finite logits; every raw point a prediction; mIoU,
   mAcc and allAcc in [0, 1]; a submission line per raw point with a
   ScanNet id; a cached rerun the same records and no launch; two
   fragments' probabilities agree with the plain attention route. Prints
   each fragment's bucket and drops, the pyramid path taken, and the
   scene's host-clock split (data pipeline, forward with geometry,
   fragment preparation, votes and argmax) with the median SSI per
   fragment;
9. train: the trainer through its CLI entry point
   (`cdsegnet_torch.tools.train.main`) on the same config at full width, as
   users train it (bf16, shuffled curves, drop_path 0.3, Mix3D 0.8, the
   shipped train transforms with scipy's elastic distortion, sphere crop to
   102,400 points, 2 scenes per 204,800-slot bucket, depth 12), on four
   synthetic rooms with phase 8's room as the val set: 2 epochs of 2 steps,
   each evaluated (SSI at the 524,288-slot bucket) and checkpointed. The
   first run stops after epoch 1 (a hook registered here raises); the second
   resumes from `model_last` at step 2 with the saved optimizer count and
   generators, trains epoch 2, evaluates, saves and runs PreciseEvaluator
   (the tester on the val room). Every step must take 36 + 36 + 36 kernel
   launches, every validation SSI 32, no plain attention; losses finite, no
   point dropped, mIoU in [0, 1]; the checkpoints, metric and event files
   and the tester's records present. Prints the host-clock step, the
   loader's data wait, the host time of one train-pipeline scene, the
   validation SSI, the checkpoint saves and the peak memory;
10. variants: the Baseline (dm=False), PTv3+CNF, plain PTv3, ScanNet200 and
   nuScenes models at the full width of their configs (random weights from a
   seed), one at a time: one SSI on phase 4's scene (nuScenes: a synthetic
   32-beam sweep through `NuScenesDataset`'s val pipeline), its route gap
   against the plain attention route on a 32,768-slot scene (`TOL_TEST`),
   and one training step of the config's optimizer on the 204,800-slot
   bucket (nuScenes: two sweeps through the train pipeline). Launches per
   SSI and per step are gated (`VARIANT_LAUNCHES`); losses finite; drops per
   level printed. Then the nuScenes tester through its CLI on the two
   sweeps: 32 launches per fragment, a lidarseg submission file per sweep;
11. time: `tools/test_time.py` at its defaults (11 SSIs of 32 launches), then
   the tester CLI with `configs/scannet/cdsegnet_time.py` on two rooms: as
   shipped (its ``aug_transform=[]`` gives no fragment) and with one
   identity pass at serialization depth 12 and 16: whole-scene fragments in
   the 262,144- and 524,288-slot buckets (two per room: some 0.1 mm voxels
   hold two points). Prints each
   fragment's largest grid coordinate, the pyramid path (packed sorts, or
   their fallback past 63 bits at depth 16), drops per level and SSI ms;
12. ddim: MSAI (``inference_step=5``) through the tester CLI on phase 8's
   room with its first augmentation: 6 forwards of 36 launches per fragment,
   no plain attention; MSFI on one fragment; that fragment's MSAI logits
   through the kernel against the plain route (`TOL_DDIM`);
13. micro: the training step of phase 6's config with ``microbatch=2``
   through `make_train_step`: two micro buckets of 102,400 slots, one
   synthetic scene each (3 warm-ups, 5 timed steps): 72 + 72 + 72 launches
   per step, no plain attention, finite losses; step ms and the peak memory
   beside phase 6's at microbatch 1;
14. ranks: process groups on this one card. (a) Two gloo ranks, both on
   cuda:0, spawned by `parallel.dist.launch`, train the config at full width
   through the training CLI (`num_devices=2`, ``microbatch=2``, 2 epochs of 2
   steps on phase 9's rooms, phase 8's room and ``room_scene(5)`` as the val
   set, one per rank); a second run stops after epoch 1 (a hook registered
   in the ranks raises) and a third resumes it; PyTorch's deterministic
   kernels on. After every step both
   ranks' parameters and running statistics must be bit-equal; the resumed
   run's checkpoint bit-equal to the uninterrupted one's (model, optimizer,
   both ranks' generators); the summed val histograms equal to one
   process's evaluation of the same weights. (b) The tester CLI on two gloo
   ranks over phase 8's room, first augmentation: records, result and preds
   equal to one process's, each rank forwarding fragments ``k % 2`` (32
   launches each). (c) The same tester call on a one-rank NCCL group.
   Times from these runs are of two processes sharing one card, not of
   several GPUs;
15. options: three models with the rest of the PTv3 surface at the full
   width of the ScanNet config (random weights from a seed): (a) FreeU
   (b_factor 1.2, s_factor 0.9 at the finest decoder stage), bidirectional
   transfer with the b_channel_scale gate, proj_drop 0.1 and the cond
   xCPE; (b) the Restomer, the lr_scale gate and the blocked xCPE; (c) RPE
   attention with every patch at 128. Each: one SSI on phase 4's scene, its
   route gap on a 32,768-slot scene (``TOL_TEST``), and the training step
   on phase 6's bucket (3 warm-ups, median of 5; peak memory). (a) and (b)
   take 32 kernel launches per SSI and 36 + 36 + 36 per step and no plain
   attention; (c) launches nothing: every self-attention takes the biased
   plain route (32 per SSI, 36 per step). Then the shipped model's SSI ms
   with the gather and the blocked xCPE ("cond" computes the gather),
   blocked against gather within
   ``TOL_TEST`` in bf16 and within 1e-5 of max |logits| in f32;
16. ablations: ③ ContinuousDM, ④ CCDM, ⑤ DiscreteDM, ⑥ CDDM and DM, the
   ScanNet model with its type swapped and the labels' branch given 20
   input channels: one SSI on phase 4's scene (32 launches, DM 26), its
   route gap (``TOL_TEST``), one training step through `make_train_step`
   on phase 6's bucket (36 + 36 + 36, DM 26 + 26 + 26; drops per level; a
   second step timed; peak memory), MSAI (5 steps: 6 forwards of 36
   launches, DM 26) and MSFI on phase 8's first fragment; then ⑥ through
   the training CLI on phase 9's rooms (one evaluated epoch of 2 steps,
   checkpoints) and the tester CLI on phase 8's room with its first
   augmentation through the non-CNF route (36 launches per fragment, every
   raw point a prediction);
17. ptv2: PTv2 at the full width of `configs/scannet/ptv2.py` (bf16, random
   weights from a seed): one eval forward on phase 4's scene (3 warm-ups,
   median of 10), the config's training step (CE + Lovasz, AdamW +
   OneCycle) on phase 6's 204,800-slot bucket (3 warm-ups, median of 5,
   peak memory), one more step recorded (the fused kNN's launches on its
   own counter, zeroed before the step, equal to the step's `knn` calls,
   one a level; the kernel's device ms and bound for the kernels line),
   at every level of that bucket the fused kNN kernel's route
   of `knn` against its dense plain version (indices equal, distances equal
   to the bit, one launch a call; the kernel's device ms, its bound and the
   dense version's ms per level), m1 and m3 (one
   condition) one eval forward each;
   everything finite, no metric level drops a point, no attention kernel
   launched;
18. shapes: ModelNet40 classification and ShapeNetPart part segmentation
   through the training and testing CLIs at the full width of their configs,
   on synthetic trees in the datasets' formats (10,000 points per ModelNet
   shape, about 2,500 per ShapeNetPart shape): 2 epochs of 2 steps, each
   evaluated (`ClsEvaluator`, `SemSegEvaluator`) and checkpointed, then
   `ClsTester` and `PartSegTester`; finite losses, accuracies and mIoUs in
   [0, 1], one prediction per shape or a vote for every point;
19. sparse: the sparse-conv family at the full width of its shipped configs
   (random weights from a seed): SpUNet-v1m1 (`configs/scannet/spunet.py`,
   f32) one eval forward on phase 4's scene (3 warm-ups, median of 10) and
   its training step (SGD with Nesterov momentum, OneCycle) on phase 6's
   bucket (3 warm-ups, median of 5, peak memory); MinkUNet and SpUNet-v1m3
   (three conditions, condition 1) one forward each; OA-CNNs
   (`configs/scannet/oacnns.py`, bf16) forward and AdamW step; CAC
   (`configs/scannet/cac_spunet.py`) its step, its four loss terms finite;
   PointGroup (`configs/scannet/insseg_pointgroup.py`) through the training
   CLI on two synthetic rooms with instance ids (phase 8's room, with ids,
   as val; GridSample keeping the ids), one evaluated epoch of 2 steps,
   `InsSegEvaluator`'s mAP, AP50 and AP25 in [0, 1]; SPVCNN
   (`configs/semantic_kitti/spvcnn.py`, bf16) through the training CLI on
   synthetic SemanticKITTI sweeps (2 train, 1 val), one evaluated epoch of
   2 steps, then the tester CLI with a submission file per sweep of known
   raw ids, and its step on phase 6's bucket; last, SpUNet's and OA-CNNs'
   f32 logits on the card against the CPU's on a 16,384-slot scene, within
   ``TOL_SPARSE_CARD`` (TF32 off). Drops per level printed (none allowed);
   no attention kernel may launch;
20. zoo: PTv1 and the window-attention family at the full width of their
   shipped configs (random weights from a seed). PTv1
   (`configs/scannet/ptv1.py`, Seg50, bf16): one eval forward on phase 4's
   scene and the AdamW + OneCycle step on phase 6's bucket, each 1 warm-up
   and 1 timed (FPS takes seconds per forward), peak memory, the
   farthest-point sampling of each level inside them (CUDA events, under
   ``torch.cuda.set_sync_debug_mode("error")``: a host read per pick fails)
   with its share, and the four levels' picks on a 16,384-slot scene equal
   on the card and the CPU. OctFormer, Stratified
   (without the config's ``gredient_clip``, which both packages refuse)
   and Swin3D (f32): one eval forward (3 warm-ups, median of 10) and the
   config's step (3 warm-ups, median of 5), peak memory and drops per
   level; their f32 logits on the card against the CPU's on a 16,384-slot
   scene within ``TOL_SPARSE_CARD``; OctFormer through the training CLI
   (one evaluated epoch of 2 steps on phase 9's rooms) and the tester CLI
   (phase 8's room, its first augmentation). Finite losses; no attention
   kernel may launch;
21. msc and ppt: MSC pretraining (`configs/scannet/pretrain_msc.py`,
   SpUNet-v1m1 in f32, random weights from a seed) on the shipped
   pipeline's first bucket of phase 9's rooms (two views of 2 x 102,400
   slots): the 1-NN pair match over the whole bucket timed alone (CUDA
   events) and within the SGD-Nesterov + OneCycle step (1 warm-up, 3 timed;
   valid pairs, ``nce_loss``, ``pos_sim``, ``neg_sim``, peak memory); the f32
   loss on the card against the CPU's on a 16,384-slot pair with injected
   draws (``TOL_MSC_CARD``); `MSCTrainer` through the training CLI on phase
   9's rooms (2 steps). Then PPT (`configs/multidataset/ppt_spunet.py`,
   PPT-v1m1 over SpUNet-v1m3 with adaptive PDNorm): `MultiDatasetTrainer`
   through the CLI on synthetic Structured3D, ScanNet (phase 9's rooms) and
   S3DIS trees, one epoch of 4 steps, ``_dataset_idx`` [0, 0, 1, 2], each
   condition trained (step ms per condition); the eval forward timed on
   phase 4's scene; PPT-v1m2 (heads 25, 20, 13) one eval forward and one
   step. Last, PPT-v1m1 with the dual branch and ``dm`` over the flagship
   PTv3 (the backbone, diffusion settings and criteria of
   `configs/scannet/cdsegnet.py`, bf16): its eval forward on phase 4's scene
   (the c-decoder included: 36 forward launches) and its AdamW step on phase
   6's bucket (36 + 36 + 36), timed, the c-decoder's kernel shapes on the
   bench scene checked in phase 3. MSC and PPT over SpUNet may launch no
   attention kernel;
22. host: the test-time covering crops, the visualizer, the decode cache
   and `RuntimeProfiler`. The tester CLI on phase 8's room and checkpoint
   with ``crop=SphereCrop(point_max=80000, mode="all")`` (JAX's default
   point_max; every grid fragment of the room holds more and splits) and
   the first 2 of the 13 augmentations (a cut in length only): as many
   fragments as the host pipeline gives on the CPU with the same seed
   (crops per grid fragment printed), 32 launches each, no plain
   attention, every raw point covered; the first and the last crop's
   probabilities, and their votes, against the plain route on the card
   (``TOL_TEST``); the first crop's kernel shapes checked in phase 3 (path
   ``crop``). Then `cdsegnet_torch/tools/visualize.py` on a coarse
   prediction (the tester's labels at one raw point per 20 cm voxel): its
   1-NN lift on the card must give every raw point the CPU lift's label
   (the PLY byte-equal). Last, the training CLI on phase 9's rooms with
   ``data.train.cache=True`` (the cache under the phase's temporary
   directory) and ``RuntimeProfiler(wait=1, active=2)``, 2 epochs of 2
   steps without evaluation: 36 + 36 + 36 launches per step, one cache file
   per scene and no other, the first bucket of a cached loader equal to an
   uncached one's array for array, one trace file, the hook's logged
   summary, and the three ``*_mma_kernel``s among the 100 heaviest names of
   the trace (`summarize_trace`). Prints the step ms with
   and without the profiler and the cache's first and later scene loads;
23. conv: the submanifold conv's implicit-GEMM kernels
   (`cdsegnet_torch/csrc/subm_conv.cu`: forward, input gradient, weight
   gradient) at the training shapes. One step each of SpUNet (f32, the
   shipped config) and the flagship (bf16) on phase 6's bucket reads the
   launches from the wrappers' counters and holds them to the convs that
   forward hooks saw run, with their tables and widths (one weight gradient
   per conv, an input gradient for all but the stems, a forward per bf16
   conv: f32 convs forward by gather + matmul); each
   distinct shape is checked against the plain version (``TOL_CONV``) and
   timed beside its bound, the plain gather + matmul (forward and
   backward) and the dense product of the gathered rows; sums per step.

Each phase prints its wall time (``phase <name> wall``). The last three lines are a JSON summary of the kernels, the card's name and
power limit, and ``{"ok": true, "device": {...}}``. Without a GPU, or
outside a checkout of the repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import collections
import contextlib
import copy
import functools
import glob
import json
import os
import re
import runpy
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import types

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
NUM_POINTS = 104448  # the bench scene of the JAX package (bench.py)
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # H100 SXM, dense
PEAK_BYTES = 3.35e12
# FP32 instructions a pair of the fused kNN (`csrc/knn.cu`) needs: five for
# the distance (a product, two multiply-adds, the -2 c multiply-add, the add
# of rr) and one compare against the k-th value. The kernel's own
# shared-memory load and loop are not counted: the bound is the function's
KNN_PAIR_INSTRUCTIONS = 6
# conv kernels against the plain version, of the largest |plain value|: f32
# sums in another order; bf16 outputs rounded once (the plain version rounds
# its product, then its bias add); weight gradients in f32 on both sides
TOL_CONV = {"float32": dict(fwd=1e-5, dgrad=1e-5, wgrad=1e-5),
            "bfloat16": dict(fwd=1e-2, dgrad=1e-2, wgrad=1e-3)}
SFU_EXP_PER_S = 16 * 132 * 1.98e9  # exp2 per clock per SM x SMs x boost clock
# kernel vs plain version on the same inputs: f32 is f32 arithmetic on both
# sides; in bf16 the plain version rounds p to bf16 before p.v
TOL_F32 = 1e-4            # max abs error
TOL_BF16 = 2e-2           # max abs error / max |o|
# SSI, kernel route vs plain route: max |dlogits| / max |logits| and argmax
# agreement on valid points, each about 3x the gap read on an H100.
# "shipped": the config as it is (bf16, upcast_softmax=False: the plain
# route rounds logits and softmax to bf16, the kernel keeps them in f32);
# "f32_softmax": upcast_softmax=True on both routes; "float32": the whole
# model in f32, which isolates the kernel from bf16 rounding
TOL_SSI = {"shipped": (0.053, 0.967), "f32_softmax": (0.047, 0.968),
           "float32": (3.5e-6, 0.9999)}
# training step, kernel route vs plain route on one scene (loss gap / loss,
# max |dg| / max |g| over all parameters), about 3x the gaps read on an H100
# (f32: 9.6e-8, one ulp of the loss, and 2.5e-6; shipped: 1.07e-4 and 0.0123);
# with both routes' max poolings on the kernel route's rows (`phase_train_gap`)
# an H100 read f32 9.6e-8 and 3.5e-7, shipped 1.7e-4 and 0.0050
TOL_TRAIN = {"float32": (3e-7, 8e-6), "shipped": (3.2e-4, 0.037)}
# phase 5's boundary layouts (N, H, D, patch, scene sizes): scenes crossing
# patches and the backward's 16-row and 8-column fragments at offsets that
# are not multiples of 8, padding rows at the tail; D = 32; patches that are
# not a multiple of the streamed tiles (128 rows) or of 16
TRAIN_EXTRA = ((8192, 2, 16, 1024, [2500, 3100, 1772]),
               (2048, 4, 32, 512, [922, 921]),
               (6000, 2, 16, 200, [1234, 2345, 1500]),
               (1920, 2, 32, 96, [333, 700, 501]))
GAP_POINTS = 32768  # one scene: the plain route keeps P*H*K*K probabilities
EVAL_POINTS = 1 << 19  # the trainer's validation bucket (`val_num_points`)
TRAIN_ROOM_SEEDS = (1, 2, 3, 4)  # phase 9's train scenes
TRAIN_TOTAL_STEPS = 1000  # OneCycle length; the smoke takes the first steps
ROOM_SEED = 0  # the tester's synthetic scene
# tester route gap as shipped, kernel route vs plain route on two fragments
# (max |dp| over the fragment's points, argmax agreement), about 3x the gap
# read on an H100 (0.090 and 98.44%)
TOL_TEST = (0.27, 0.953)
# MSAI (5 steps) on one tester fragment, kernel route vs plain route as
# shipped (max |dlogits| / max |logits|, argmax agreement), about 3x the gap
# read on an H100 (1.59% and 98.98%)
TOL_DDIM = (0.048, 0.969)
# phase 10's model variants and their kernel launches per training step and
# per SSI (the c-decoder runs in training only; plain PTv3 has no c-branch)
NUSCENES = "nuscenes/cdsegnet.py"
VARIANTS = ("scannet/baseline.py", "scannet/ptv3_cnf.py", "scannet/ptv3_plain.py",
            "scannet200/cdsegnet.py", NUSCENES)
VARIANT_LAUNCHES = {"scannet/baseline.py": (36, 32), "scannet/ptv3_cnf.py": (32, 28),
                    "scannet/ptv3_plain.py": (26, 26), "scannet200/cdsegnet.py": (36, 32),
                    NUSCENES: (36, 32)}
SWEEP_SEEDS = (1, 2)  # the synthetic nuScenes sweeps
TIME_CONFIG = "scannet/cdsegnet_time.py"
# the timing protocol's rooms: about 200,000 raw points, and phase 8's room
TIME_ROOMS = (dict(seed=5, cell=0.023), dict(seed=ROOM_SEED))
TIME_BUCKETS = (262144, 524288)  # their whole-scene fragments
MICRO_SEEDS = (0, 1)  # phase 13's two micro buckets, one scene each
VAL_ROOM_SEED = 5  # phase 14's second val room
RANKS_MSAI_STEPS = 2  # phase 14b's MSAI on two ranks: 3 DDIM forwards a fragment


def fail(msg: str) -> None:
    raise RuntimeError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


def cuda_ms(torch, fn, warmup: int = 3, iters: int = 10) -> float:
    """Mean time of ``fn`` over ``iters`` back-to-back calls, CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def profiled_ms(prof, name: str) -> float:
    """Device ms of the kernels whose name holds ``name`` in a finished
    ``torch.profiler`` run."""
    us = sum(getattr(e, "device_time_total", 0) or getattr(e, "cuda_time_total", 0)
             for e in prof.key_averages() if name in e.key)
    return us / 1e3


def device_ms(torch, fn, name: str, iters: int = 3) -> float:
    """Device ms per call of the kernels whose name holds ``name``, from the
    profiler's CUDA activity over ``iters`` calls after one warm-up."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return profiled_ms(prof, name) / iters


def attention_launches(backbone_cfg: dict, c_decoder: bool = False):
    """``(level, curve order, heads, head dim)`` of every launch of the
    patch-attention kernel in one forward: the n-encoder, n-decoder and
    c-encoder blocks, and last the c-decoder's when ``c_decoder`` (training
    and DDIM run it; SSI skips it). A single-branch backbone
    (``condition=False``) has no c-branch."""
    from cdsegnet_torch.models.ptv3 import _cumshift

    b = backbone_cfg
    n_orders = len(b["order"])
    n_shift, c_shift = _cumshift(b["n_stride"]), _cumshift(b["c_stride"])
    n_dec_ch = list(b["n_dec_channels"]) + [b["n_enc_channels"][-1]]
    stages = [(n_shift[s], b["n_enc_num_head"][s], b["n_enc_channels"][s], d)
              for s, d in enumerate(b["n_enc_depths"])]
    stages += [(n_shift[s], b["n_dec_num_head"][s], n_dec_ch[s], d)
               for s, d in enumerate(b["n_dec_depths"])]
    if b.get("condition", True):
        stages += [(c_shift[s], b["c_enc_num_head"][s], b["c_enc_channels"][s], d)
                   for s, d in enumerate(b["c_enc_depths"])]
        if c_decoder:
            stages += [(c_shift[s], b["c_dec_num_head"][s], b["c_dec_channels"][s], d)
                       for s, d in enumerate(b["c_dec_depths"])]
    return [(level, i % n_orders, h, c // h)
            for level, h, c, depth in stages for i in range(depth)]


def scene_layout(torch, n: int, scene_sizes, device):
    """Sorted scene ids and validity: scenes back to back, padding (with the
    sentinel scene id) at the tail."""
    batch = np.full(n, len(scene_sizes), np.int32)
    start = 0
    for s, size in enumerate(scene_sizes):
        batch[start:start + size] = s
        start += size
    valid = np.arange(n) < start
    return (torch.as_tensor(batch, device=device),
            torch.as_tensor(valid, device=device))


def check_kernel_case(torch, batch, valid, h, d, patch, dtype, gen):
    """Kernel vs plain version on random q, k, v with the given scene ids and
    validity; returns the measurements."""
    import torch.nn.functional as F

    from cdsegnet_torch.ops.attention import patch_attention
    from cdsegnet_torch.ops.flash_attention import patch_attention_fwd

    n = batch.shape[0]
    q, k, v = (torch.randn((n, h, d), generator=gen, device=batch.device).to(dtype)
               for _ in range(3))
    scale = d ** -0.5
    out = patch_attention_fwd(q, k, v, batch, valid, patch, scale)
    again = patch_attention_fwd(q, k, v, batch, valid, patch, scale)
    torch.cuda.synchronize()
    want = patch_attention(q, k, v, batch, valid, patch, scale, upcast_softmax=True)
    name = str(dtype).replace("torch.", "")
    if not torch.equal(out, again):
        fail(f"two forward runs differ at {(n, h, d)} patch {patch} {name}")
    del again
    if not torch.isfinite(out.float()).all():
        fail(f"kernel output has non-finite rows at {(n, h, d)} {name}")
    err = (out.float() - want.float())[valid].abs().max().item()
    ref = want.float()[valid].abs().max().item()
    if err > (TOL_F32 if dtype == torch.float32 else TOL_BF16 * ref):
        fail(f"kernel disagrees with plain at {(n, h, d)} {name}: "
             f"max abs err {err:.3e} (max |o| {ref:.3e})")

    p = n // patch
    bp = batch.view(p, patch)
    allowed = (bp[:, :, None] == bp[:, None, :]) & valid.view(p, 1, patch)
    pairs = int(allowed.sum().item())  # (query, key) pairs this data needs
    to4 = lambda x: x.view(p, patch, h, d).transpose(1, 2).contiguous()
    q4, k4, v4, m4 = to4(q), to4(k), to4(v), allowed[:, None]
    kernel_ms = cuda_ms(torch, lambda: patch_attention_fwd(q, k, v, batch, valid,
                                                           patch, scale))
    plain_ms = cuda_ms(torch, lambda: patch_attention(q, k, v, batch, valid, patch,
                                                      scale, upcast_softmax=True))
    library_ms = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
        q4, k4, v4, attn_mask=m4, scale=scale))
    # what this data needs: the allowed pairs' products; q, k, v of the valid
    # rows read, o of every row written, scene ids and validity read
    n_valid = int(valid.sum().item())
    flops = 4.0 * d * h * pairs
    nbytes = (n + 3.0 * n_valid) * h * d * q.element_size() + 5.0 * n
    ops_ms = flops / PEAK_FLOPS[name] * 1e3
    bytes_ms = nbytes / PEAK_BYTES * 1e3
    return dict(shape=[n, h, d], patch=patch, dtype=name, max_abs_err=err,
                max_abs_out=ref, ms=kernel_ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=max(ops_ms, bytes_ms),
                ops_ms=ops_ms, bytes_ms=bytes_ms, exps=h * pairs,
                valid_rows=n_valid)


SUMMED = ("ms", "plain_ms", "library_ms", "bound_ms", "ops_ms", "bytes_ms", "exps")


def phase_kernels(torch, levels, launches, patch, path="ssi"):
    """Every distinct launch of an SSI forward (level, curve order, heads,
    head dim), on that level's real scene ids and validity, in bf16 and f32;
    then, on the ``"ssi"`` path, padded multi-scene batches. Returns the
    main-path rows, each with its launch count per SSI forward."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    counts: dict = {}
    for key in launches:
        counts[key] = counts.get(key, 0) + 1
    rows = []
    for (level, oi, h, d), count in counts.items():
        pt = levels[level].point
        for dtype in (torch.bfloat16, torch.float32):
            r = check_kernel_case(torch, pt.batch_sorted[oi], pt.mask_sorted[oi],
                                  h, d, patch, dtype, gen)
            r.update(level=level, order=oi, launches_per_ssi=count, path=path)
            rows.append(r)
            print("kernel patch_attention_fwd " + json.dumps(r), flush=True)
    # three scenes crossing patch boundaries with 10% padding (rows without
    # an allowed key), and the D=32 shape of the JAX bench's parity check
    for n, h, d, p, sizes in ((8192, 2, 16, 1024, [2500, 3100, 1772]),
                              (2048, 4, 32, 512, [922, 921])) if path == "ssi" else ():
        batch, valid = scene_layout(torch, n, sizes, "cuda")
        for dtype in (torch.bfloat16, torch.float32):
            r = check_kernel_case(torch, batch, valid, h, d, p, dtype, gen)
            print("kernel patch_attention_fwd extra " + json.dumps(r), flush=True)
    # per main-path shape: sums over that shape's launches in one forward
    for dtype in ("bfloat16", "float32"):
        shapes: dict = {}
        for r in rows:
            if r["dtype"] != dtype:
                continue
            agg = shapes.setdefault(tuple(r["shape"]), dict(
                {k: 0.0 for k in SUMMED}, launches=0, max_abs_err=0.0))
            agg["launches"] += r["launches_per_ssi"]
            agg["max_abs_err"] = max(agg["max_abs_err"], r["max_abs_err"])
            for k in SUMMED:
                agg[k] += r[k] * r["launches_per_ssi"]
        for shape, agg in shapes.items():
            agg["bound_by"] = "operations" if agg["ops_ms"] >= agg["bytes_ms"] else "bytes"
            print("shape " + json.dumps(dict(shape=list(shape), dtype=dtype, path=path,
                                             **agg)), flush=True)
    return rows


def phase_ssi(torch, cfg, model, point, n_launches, card):
    from cdsegnet_torch.models.builder import build_model
    from cdsegnet_torch.ops.flash_attention import patch_attention_fwd

    noise = torch.randn((NUM_POINTS, 6), device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(7))
    valid = point.mask
    n_valid = int(valid.sum().item())

    patch_attention_fwd.launches = 0
    logits = model.inference(point, noise=noise)["seg_logits"]
    torch.cuda.synchronize()
    launches = patch_attention_fwd.launches
    print(f"ssi kernel launches per forward {launches} (expected {n_launches})",
          flush=True)
    if launches != n_launches:
        fail(f"SSI launched the attention kernel {launches} times, "
             f"expected {n_launches}")
    if tuple(logits.shape) != (NUM_POINTS, 20):
        fail(f"logits shape {tuple(logits.shape)}")
    if not torch.isfinite(logits[valid]).all():
        fail("non-finite logits on valid points")

    def route(route_cfg, use_pallas):
        c = copy.deepcopy(route_cfg)
        c["backbone"]["use_pallas"] = use_pallas
        m = build_model(c, device="cuda", generator=torch.Generator().manual_seed(0))
        return m.inference(point, noise=noise)["seg_logits"]

    def gap(got, want):
        return dict(max_abs_dlogits=(got - want)[valid].abs().max().item(),
                    max_abs_logits=want[valid].abs().max().item(),
                    argmax_agree=(got.argmax(1) == want.argmax(1))[valid]
                    .float().mean().item())

    # same weights (seed 0) and noise on every route
    f32_softmax = copy.deepcopy(cfg)
    f32_softmax["backbone"]["upcast_softmax"] = True
    float32 = copy.deepcopy(f32_softmax)
    float32["backbone"]["dtype"] = "float32"
    plain_shipped, plain_f32_softmax = route(cfg, False), route(f32_softmax, False)
    gaps = dict(shipped=gap(logits, plain_shipped),
                f32_softmax=gap(route(f32_softmax, None), plain_f32_softmax),
                float32=gap(route(float32, None), route(float32, False)))
    # the bf16 noise floor: two plain routes that differ only in where they
    # round; reported beside the kernel's gaps, not held to a tolerance
    floor = gap(plain_f32_softmax, plain_shipped)
    for name, g in list(gaps.items()) + [("plain_floor", floor)]:
        rel = g["max_abs_dlogits"] / g["max_abs_logits"]
        print(f"ssi route gap {name}: max |dlogits| "
              f"{g['max_abs_dlogits']:.4e} (max |logits| {g['max_abs_logits']:.4e}, "
              f"{rel:.4%}), argmax agreement {g['argmax_agree']:.5f}", flush=True)
    for name, g in gaps.items():
        tol_rel, tol_agree = TOL_SSI[name]
        if (g["max_abs_dlogits"] > tol_rel * g["max_abs_logits"]
                or g["argmax_agree"] < tol_agree):
            fail(f"SSI kernel route disagrees with the plain route ({name})")

    torch.cuda.reset_peak_memory_stats()
    times = []
    for i in range(13):  # 3 warm-ups, then 10 timed steps, geometry included
        t0 = time.perf_counter()
        model.inference(point, noise=noise)
        torch.cuda.synchronize()
        if i >= 3:
            times.append(time.perf_counter() - t0)
    step_ms = statistics.median(times) * 1e3
    result = dict(step_ms=step_ms, step_ms_all=[t * 1e3 for t in times],
                  points_per_s=n_valid / (step_ms / 1e3), n_valid=n_valid,
                  launches=launches, route_gaps=dict(gaps, plain_floor=floor),
                  peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                  card=card)
    print("ssi " + json.dumps(result), flush=True)
    return result


def shape_bound(flops, nbytes, dtype_name):
    ops_ms = flops / PEAK_FLOPS[dtype_name] * 1e3
    bytes_ms = nbytes / PEAK_BYTES * 1e3
    return dict(bound_ms=max(ops_ms, bytes_ms), ops_ms=ops_ms, bytes_ms=bytes_ms,
                bound_by="operations" if ops_ms >= bytes_ms else "bytes")


def check_train_case(torch, batch, valid, h, d, patch, dtype, gen, timed=True):
    """The forward kernel with its log-sum-exp and the two backward kernels
    against autograd through the plain version, on random q, k, v and an
    output gradient that is zero on invalid rows, and a second forward and
    backward run bit-equal to the first; then, when ``timed``, the times of
    each direction beside its bound, the plain version and SDPA."""
    import torch.nn.functional as F

    from cdsegnet_torch.ops import flash_attention as fa
    from cdsegnet_torch.ops.attention import patch_attention

    n = batch.shape[0]
    name = str(dtype).replace("torch.", "")
    scale = d ** -0.5
    q, k, v, g = (torch.randn((n, h, d), generator=gen, device=batch.device)
                  for _ in range(4))
    q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
    g = torch.where(valid[:, None, None], g, 0.0).to(dtype)

    out, lse = fa._launch_fwd(q, k, v, batch, valid, patch, scale, with_lse=True)
    out2, lse2 = fa._launch_fwd(q, k, v, batch, valid, patch, scale, with_lse=True)
    dq, delta = fa.patch_attention_bwd_dq(q, k, v, out, g, lse, batch, valid,
                                          patch, scale)
    dk, dv = fa.patch_attention_bwd_dkdv(q, k, v, g, lse, delta, batch, valid,
                                         patch, scale)
    dq2, delta2 = fa.patch_attention_bwd_dq(q, k, v, out, g, lse, batch, valid,
                                            patch, scale)
    dk2, dv2 = fa.patch_attention_bwd_dkdv(q, k, v, g, lse, delta2, batch, valid,
                                           patch, scale)
    torch.cuda.synchronize()
    if not (torch.equal(out, out2) and torch.equal(lse, lse2)):
        fail(f"two forward runs differ at {(n, h, d)} patch {patch} {name}")
    if not all(torch.equal(a, b) for a, b in
               ((dq, dq2), (delta, delta2), (dk, dk2), (dv, dv2))):
        fail(f"two backward runs differ at {(n, h, d)} patch {patch} {name}")
    del out2, lse2, dq2, delta2, dk2, dv2
    leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
    ref_out = patch_attention(*leaves, batch, valid, patch, scale,
                              upcast_softmax=True)
    ref = torch.autograd.grad(ref_out, leaves, g, retain_graph=True)

    p = n // patch
    bp = batch.view(p, patch)
    allowed = (bp[:, :, None] == bp[:, None, :]) & valid.view(p, 1, patch)
    pairs = int(allowed.sum().item())  # (query, key) pairs this data needs
    with torch.no_grad():
        s4 = torch.einsum("pihd,pjhd->phij", q.float().view(p, patch, h, d),
                          k.float().view(p, patch, h, d)) * scale
        want_lse = torch.logsumexp(s4.masked_fill(~allowed[:, None], float("-inf")),
                                   -1).permute(0, 2, 1).reshape(n, h)
        del s4
    errs = dict(lse=(lse - want_lse)[valid].abs().max().item(),
                o=(out.float() - ref_out.float())[valid].abs().max().item())
    refs = dict(o=ref_out.float()[valid].abs().max().item())
    for nm, a, w in (("dq", dq, ref[0]), ("dk", dk, ref[1]), ("dv", dv, ref[2])):
        if not torch.isfinite(a.float()).all():
            fail(f"{nm} has non-finite rows at {(n, h, d)} {name}")
        errs[nm] = (a.float() - w.float()).abs().max().item()
        refs[nm] = w.float().abs().max().item()
    for nm, err in errs.items():
        tol = 1e-4 if (nm == "lse" or dtype == torch.float32) else TOL_BF16 * refs[nm]
        if err > tol:
            fail(f"{nm} of the kernels disagrees with autograd through the "
                 f"plain version at {(n, h, d)} {name}: max abs err {err:.3e} "
                 f"(max |ref| {refs.get(nm, 0.0):.3e})")
    if not torch.isfinite(lse[valid]).all():
        fail(f"lse is not finite on valid rows at {(n, h, d)} {name}")
    if not timed:
        return dict(shape=[n, h, d], patch=patch, dtype=name, max_abs_err=errs,
                    max_abs_ref=refs, valid_rows=int(valid.sum().item()))

    to4 = lambda x: x.view(p, patch, h, d).transpose(1, 2).contiguous()
    q4, k4, v4 = (to4(x).requires_grad_(True) for x in (q, k, v))
    g4, m4 = to4(g), allowed[:, None]
    sdpa = lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=m4, scale=scale)
    o4 = sdpa()
    # the bytes this data needs: the inputs of the valid rows read (q, k, v,
    # o, g; lse and delta in f32), the outputs of every row written, scene
    # ids and validity read
    nv = int(valid.sum().item())
    hd = h * d * q.element_size()
    fwd = dict(
        ms=cuda_ms(torch, lambda: fa._launch_fwd(q, k, v, batch, valid, patch, scale,
                                                 with_lse=True), 2, 5),
        plain_ms=cuda_ms(torch, lambda: patch_attention(
            q, k, v, batch, valid, patch, scale, upcast_softmax=True), 2, 5),
        library_ms=cuda_ms(torch, lambda: sdpa().detach(), 2, 5),
        **shape_bound(4.0 * d * h * pairs, (n + 3.0 * nv) * hd + 4.0 * n * h + 5.0 * n,
                      name))

    # each backward kernel beside the plain version's and SDPA's gradients
    # of the same tensors (autograd computes only what they need)
    dq_ = dict(
        ms=cuda_ms(torch, lambda: fa.patch_attention_bwd_dq(
            q, k, v, out, g, lse, batch, valid, patch, scale), 2, 5),
        plain_ms=cuda_ms(torch, lambda: torch.autograd.grad(
            ref_out, leaves[:1], g, retain_graph=True), 2, 5),
        library_ms=cuda_ms(torch, lambda: torch.autograd.grad(
            o4, (q4,), g4, retain_graph=True), 2, 5),
        **shape_bound(6.0 * d * h * pairs,
                      (n + 5.0 * nv) * hd + 4.0 * (n + nv) * h + 5.0 * n, name))
    dkdv = dict(
        ms=cuda_ms(torch, lambda: fa.patch_attention_bwd_dkdv(
            q, k, v, g, lse, delta, batch, valid, patch, scale), 2, 5),
        plain_ms=cuda_ms(torch, lambda: torch.autograd.grad(
            ref_out, leaves[1:], g, retain_graph=True), 2, 5),
        library_ms=cuda_ms(torch, lambda: torch.autograd.grad(
            o4, (k4, v4), g4, retain_graph=True), 2, 5),
        **shape_bound(8.0 * d * h * pairs, (2.0 * n + 4.0 * nv) * hd + 8.0 * nv * h + 5.0 * n,
                      name))
    # the whole backward: 10 D FLOPs per pair (s, dp, dv, dq, dk); q, k, v,
    # o, g and lse of the valid rows read and dq, dk, dv written once; plain
    # and SDPA computing all three
    bwd = dict(
        ms=dq_["ms"] + dkdv["ms"],
        plain_ms=cuda_ms(torch, lambda: torch.autograd.grad(
            ref_out, leaves, g, retain_graph=True), 2, 5),
        library_ms=cuda_ms(torch, lambda: torch.autograd.grad(
            o4, (q4, k4, v4), g4, retain_graph=True), 2, 5),
        **shape_bound(10.0 * d * h * pairs, (3.0 * n + 5.0 * nv) * hd + 4.0 * nv * h + 5.0 * n,
                      name))
    return dict(shape=[n, h, d], patch=patch, dtype=name, max_abs_err=errs,
                max_abs_ref=refs, exps=h * pairs, fwd=fwd, dq=dq_, dkdv=dkdv,
                bwd=bwd, valid_rows=nv)


def phase_train_kernels(torch, levels, launches, patch, path="train"):
    """Every training-step shape (level, heads, head dim), on that level's
    real scene ids and validity (the same for every curve: scenes sort
    whole, padding last), in bf16 and f32 (f32 untimed off the ``"train"``
    path, which alone adds the boundary layouts). Returns the rows, each
    with its launches per step; prints the sums per step."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    counts: dict = {}
    for level, _, h, d in launches:
        counts[(level, h, d)] = counts.get((level, h, d), 0) + 1
    rows = []
    for (level, h, d), count in counts.items():
        pt = levels[level].point
        for dtype in (torch.bfloat16, torch.float32):
            timed = path == "train" or dtype == torch.bfloat16
            r = check_train_case(torch, pt.batch_sorted[0], pt.mask_sorted[0],
                                 h, d, patch, dtype, gen, timed=timed)
            r.update(level=level, launches_per_step=count, path=path)
            if timed:
                rows.append(r)
            print("train kernels " + json.dumps(r), flush=True)
    for n, h, d, p, sizes in TRAIN_EXTRA if path == "train" else ():
        batch, valid = scene_layout(torch, n, sizes, "cuda")
        for dtype in (torch.bfloat16, torch.float32):
            r = check_train_case(torch, batch, valid, h, d, p, dtype, gen, timed=False)
            print("train kernels extra " + json.dumps(r), flush=True)
    for dtype in ("bfloat16", "float32") if path == "train" else ("bfloat16",):
        for direction in ("fwd", "dq", "dkdv", "bwd"):
            tot = {key: sum(r[direction][key] * r["launches_per_step"]
                            for r in rows if r["dtype"] == dtype)
                   for key in ("ms", "plain_ms", "library_ms", "bound_ms",
                               "ops_ms", "bytes_ms")}
            # one exponential per allowed pair in each kernel (two in the
            # backward), at the SFU's published rate: a ceiling computed,
            # not measured
            tot["exps"] = (2 if direction == "bwd" else 1) * sum(
                r["exps"] * r["launches_per_step"] for r in rows if r["dtype"] == dtype)
            tot["sfu_ms"] = tot["exps"] / SFU_EXP_PER_S * 1e3
            print(f"train kernels per step {path} {dtype} {direction} " + json.dumps(tot),
                  flush=True)
    return rows


def train_setup(torch, conf, cfg, device="cuda", **backbone):
    """Model (random weights from seed 0, training mode), criteria and
    optimizer of the config, with backbone fields overridden."""
    from cdsegnet_torch.engine.optimizer import build_optimizer
    from cdsegnet_torch.models.builder import build_model, build_model_criteria

    c = copy.deepcopy(cfg)
    c["backbone"].update(backbone)
    model = build_model(c, device=device, generator=torch.Generator().manual_seed(0))
    model.train()
    opt = build_optimizer(dict(conf["optimizer"]), model, dict(conf["scheduler"]),
                          total_steps=TRAIN_TOTAL_STEPS,
                          param_dicts=[dict(p) for p in conf["param_dicts"]],
                          clip_keywords=conf.get("gredient_clip", []), device=device)
    return model, build_model_criteria(c), opt


def phase_train(torch, conf, cfg, point, n_launches, card):
    from cdsegnet_torch.engine.state import make_train_step
    from cdsegnet_torch.ops import flash_attention as fa
    from cdsegnet_torch.utils import cuda_build

    model, criteria, opt = train_setup(torch, conf, cfg)
    step = make_train_step(model, criteria, opt, seed=0, device="cuda")
    named = dict(model.named_parameters())
    probe = {g: next(n for n, lab in opt.labels.items() if lab == g)
             for g in set(opt.labels.values())}
    before = {n: named[n].detach().clone() for n in probe.values()}
    stats0 = {n: b.clone() for n, b in model.named_buffers()}

    cuda_build.reset_launch_counts()
    metrics = step(point)
    torch.cuda.synchronize()
    counts = dict(fwd=fa.patch_attention_fwd.launches,
                  fwd_lse=fa.patch_attention_fwd.lse_launches,
                  bwd_dq=fa.patch_attention_bwd_dq.launches,
                  bwd_dkdv=fa.patch_attention_bwd_dkdv.launches)
    print(f"train kernel launches per step {json.dumps(counts)} "
          f"(expected {n_launches} each)", flush=True)
    if any(c != n_launches for c in counts.values()):
        fail(f"the training step launched the kernels {counts} times, "
             f"expected {n_launches} each")
    loss = metrics["loss"].item()
    drops = [metrics[f"dropped_l{i}"] for i in range(1, 5)]
    bad = [n for n, p in named.items() if p.grad is None or not torch.isfinite(p.grad).all()]
    moved = {g: not torch.equal(named[n], before[n]) for g, n in probe.items()}
    stats_moved = sum(not torch.equal(b, stats0[n]) for n, b in model.named_buffers())
    print(f"train first step: loss {loss:.6f}, dropped per level {drops}, "
          f"parameters without a finite gradient {len(bad)}, groups moved {moved}, "
          f"running statistics changed {stats_moved} of {len(stats0)}", flush=True)
    if not np.isfinite(loss) or bad or drops != [0, 0, 0, 0]:
        fail(f"training step: loss {loss}, non-finite or missing gradients "
             f"{bad[:5]}, drops {drops}")
    if not all(moved.values()) or stats_moved != len(stats0):
        fail(f"training step: parameter groups moved {moved}, running "
             f"statistics changed {stats_moved} of {len(stats0)}")

    torch.cuda.reset_peak_memory_stats()
    times, losses = [], []
    for i in range(8):  # 3 warm-ups, then 5 timed steps
        t0 = time.perf_counter()
        m = step(point)
        torch.cuda.synchronize()
        losses.append(m["loss"].item())
        if i >= 3:
            times.append(time.perf_counter() - t0)
    if not np.isfinite(losses).all():
        fail(f"non-finite training loss {losses}")
    n_valid = int(point.mask.sum().item())
    step_ms = statistics.median(times) * 1e3
    result = dict(step_ms=step_ms, step_ms_all=[t * 1e3 for t in times],
                  points_per_s=n_valid / (step_ms / 1e3), n_valid=n_valid,
                  slots=point.num_points, launches=counts, losses=[loss] + losses,
                  peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                  lrs=opt.lrs(), card=card)
    print("train " + json.dumps(result), flush=True)
    return result


def max_picks(torch, values, level):
    """Per segment and channel of a max pooling, the lowest sorted row whose
    valid value equals the segment's max; ``len(values)`` where the segment
    has no valid row."""
    from cdsegnet_torch.ops import segments as seg_ops

    top = seg_ops.segment_reduce(values, level.pool_seg, level.size, "max",
                                 level.pool_valid)
    n = values.shape[0]
    seg = level.pool_seg.long()[:, None].expand_as(values)
    rows = torch.arange(n, device=values.device)[:, None].expand_as(values)
    hit = (values == top.gather(0, seg)) & level.pool_valid[:, None]
    picks = torch.full(top.shape, n, dtype=torch.int64, device=values.device)
    return picks.scatter_reduce_(0, seg, torch.where(hit, rows, n), "amin")


def pinned_max_pooling(torch, picks, flips):
    """``make`` for `patched` over `pyramid.pool_features`: a max pooling
    that reads one row per segment and channel, so that its gradient reaches
    that row alone. With ``picks`` empty it records its own maxima there
    (`max_picks`); with them full it reads the recorded rows call by call
    and appends to ``flips`` how many of its own maxima lie elsewhere. Two
    routes that round a near-tie apart so send their gradients to the same
    rows."""
    replay = bool(picks)

    def make(original):
        calls = iter(picks) if replay else None

        def pool(feat, level, reduce="max"):
            if reduce != "max":
                return original(feat, level, reduce)
            values = feat[level.pool_sort]
            with torch.no_grad():
                own = max_picks(torch, values, level)
            if replay:
                pick = next(calls)
                flips.append(int((own != pick).sum().item()))
            else:
                pick = own
                picks.append(own)
            padded = torch.cat([values, values.new_zeros((1,) + values.shape[1:])])
            return padded.gather(0, pick)
        return pool
    return make


def phase_train_gap(torch, conf, cfg):
    """One step's loss and gradients, kernel route against plain route, on
    one scene: drop_path 0, no shuffle, the same t, noise and MSE mask. The
    max poolings of both routes take the rows that the kernel route's own
    maxima chose (`pinned_max_pooling`): where the routes round a near-tie
    apart, a segment's gradient would otherwise go to another row, and the
    gap would measure where such a flip lands, not the attention kernel."""
    from cdsegnet_torch.models import pyramid as pyr
    from cdsegnet_torch.utils.synthetic import synthetic_point_batch

    point = synthetic_point_batch(GAP_POINTS, 1, depth=12, seed=1, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(3)
    inject = dict(ts_scene=torch.tensor([321], device="cuda"),
                  noise=torch.randn((GAP_POINTS, 6), generator=gen, device="cuda"),
                  mse_valid=point.mask & (torch.rand(GAP_POINTS, generator=gen,
                                                     device="cuda") < 0.25))

    def grads(dtype, use_pallas, picks, flips):
        model, criteria, _ = train_setup(torch, conf, cfg, drop_path=0.0,
                                         shuffle_orders=False, dtype=dtype,
                                         use_pallas=use_pallas)
        with patched((pyr, "pool_features", pinned_max_pooling(torch, picks, flips))):
            loss = criteria(model(point, **inject), mode="train")
            params = [p for _, p in model.named_parameters()]
            gs = torch.autograd.grad(loss, params)
        return loss.item(), [g.float() for g in gs]

    gaps = {}
    for name, dtype in (("float32", "float32"), ("shipped", cfg["backbone"]["dtype"])):
        picks, flips = [], []
        lk, gk = grads(dtype, None, picks, flips)
        lp, gp = grads(dtype, False, picks, flips)
        if not picks or len(flips) != len(picks):
            fail(f"training step ({name}): the plain route pooled {len(flips)} times, "
                 f"the kernel route {len(picks)}")
        max_g = max(g.abs().max().item() for g in gp)
        max_dg = max((a - b).abs().max().item() for a, b in zip(gk, gp))
        worst = max((a - b).abs().max().item() / max(b.abs().max().item(), 1e-30)
                    for a, b in zip(gk, gp))
        gaps[name] = dict(loss_kernel=lk, loss_plain=lp,
                          loss_gap=abs(lk - lp) / abs(lp), max_abs_dg=max_dg,
                          max_abs_g=max_g, dg_rel=max_dg / max_g,
                          worst_tensor_dg_rel=worst, pinned_flips=flips,
                          finite=all(torch.isfinite(g).all().item() for g in gk))
        del gk, gp
        torch.cuda.empty_cache()
        print(f"train route gap {name} " + json.dumps(gaps[name]), flush=True)
    for name, g in gaps.items():
        tol_loss, tol_dg = TOL_TRAIN[name]
        if not g["finite"] or g["loss_gap"] > tol_loss or g["dg_rel"] > tol_dg:
            fail(f"training step, kernel route disagrees with the plain route ({name})")
    return gaps


@contextlib.contextmanager
def patched(*patches):
    """For the block, replace each attribute ``(owner, name, make)`` with
    ``make(original)``; restore the originals after."""
    saved = [(owner, name, getattr(owner, name)) for owner, name, _ in patches]
    try:
        for owner, name, make in patches:
            setattr(owner, name, make(getattr(owner, name)))
        yield
    finally:
        for owner, name, original in saved:
            setattr(owner, name, original)


def tester_scene(torch, config, tmp):
    """Write the room as ``<tmp>/data/val/scene0000_00.pth`` and run the
    shipped test pipeline on it once (13 augmentations, 2 cm test-mode grid
    sampling), as the tester will; returns the raw point count and the
    test-mode item."""
    from cdsegnet_torch.data.collate import pick_bucket
    from cdsegnet_torch.data.datasets import build_dataset
    from cdsegnet_torch.engine.config import Config
    from cdsegnet_torch.engine.test import DEFAULT_BUCKETS
    from cdsegnet_torch.utils.synthetic import room_scene

    room = room_scene(ROOM_SEED)
    os.makedirs(os.path.join(tmp, "data", "val"))
    torch.save(room, os.path.join(tmp, "data", "val", "scene0000_00.pth"))
    cfg = Config.fromfile(config)
    cfg.data.test["data_root"] = os.path.join(tmp, "data")
    ds = build_dataset(dict(cfg.data.test))
    per_aug = []
    voxelize = ds.test_voxelize

    def counted(data, rng):
        parts = voxelize(data, rng)
        per_aug.append(len(parts))
        return parts

    ds.test_voxelize = counted
    t0 = time.perf_counter()
    scene = ds.get(0, np.random.default_rng(cfg.seed))
    pipeline_s = time.perf_counter() - t0
    n_raw = len(room["coord"])
    sizes = [len(f["coord"]) for f in scene["fragment_list"]]
    buckets = sorted({pick_bucket(n, DEFAULT_BUCKETS) for n in sizes})
    grid = np.floor(room["coord"] / 0.02).astype(np.int64)
    _, occupancy = np.unique(grid, axis=0, return_counts=True)
    print(f"test scene {n_raw} raw points in {len(occupancy)} voxels of 2 cm "
          f"({n_raw / len(occupancy):.2f} points each on average, {occupancy.min()}-"
          f"{occupancy.max()}, before augmentation); "
          f"{len(per_aug)} augmentations x largest voxel occupancy {per_aug} = "
          f"{len(sizes)} fragments of {min(sizes)}-{max(sizes)} points, buckets "
          f"{buckets}; test pipeline {pipeline_s:.2f} s on the host", flush=True)
    if len(per_aug) != 13 or buckets != [131072]:
        fail("the test scene does not give 13 augmentations in the 131,072 bucket")
    return n_raw, scene


def forward_sums(rows):
    """bf16 sums over one SSI forward's launches (each row timed on its
    level's real scene ids and validity)."""
    main = [r for r in rows if r["dtype"] == "bfloat16"]
    total = lambda key: sum(r[key] * r["launches_per_ssi"] for r in main)
    return dict(launches=sum(r["launches_per_ssi"] for r in main),
                max_abs_err=max(r["max_abs_err"] for r in main),
                ms=total("ms"), plain_ms=total("plain_ms"), bound_ms=total("bound_ms"),
                library_ms=total("library_ms"),
                bound_by="operations" if total("ops_ms") >= total("bytes_ms") else "bytes")


def phase_test(torch, config, cfg, tmp, n_raw, scene, n_launches, card):
    """The tester through its CLI entry point on the room scene, with a
    checkpoint saved by the port's `CheckpointManager`: per-fragment
    launches, plain-attention calls, drops and finiteness; coverage, metrics
    and the submission; a cached rerun; then the route gap on two
    fragments."""
    from cdsegnet_torch.data import datasets
    from cdsegnet_torch.data.collate import pick_bucket
    from cdsegnet_torch.engine.checkpoint import CheckpointManager, snapshot
    from cdsegnet_torch.engine.test import DEFAULT_BUCKETS, SemSegTester
    from cdsegnet_torch.models.builder import build_model
    from cdsegnet_torch.models.ptv3 import PointTransformerV3
    from cdsegnet_torch.ops import flash_attention as fa
    from cdsegnet_torch.tools import test as test_tool
    from cdsegnet_torch.utils import cuda_build

    save = os.path.join(tmp, "exp")
    model = build_model(cfg, device="cuda", generator=torch.Generator().manual_seed(0))
    CheckpointManager(os.path.join(save, "model")).save(snapshot(model), "model_last")
    del model
    argv = ["--config-file", config, "--checkpoint", "model_last", "--options",
            f"data.test.data_root={os.path.join(tmp, 'data')}", f"save_path={save}",
            "submission=True"]

    frags, covered = [], np.zeros(n_raw, bool)
    times = dict(test=0.0, data=0.0, scene=0.0, fragments=0.0)
    plain_calls, drops = [0], [None]

    def timed(key, sync=False):
        def make(fn):
            def run(*args, **kwargs):
                if sync:
                    torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(*args, **kwargs)
                if sync:
                    torch.cuda.synchronize()
                times[key] += time.perf_counter() - t0
                if key == "fragments":
                    covered[args[1]["index"]] = True
                return out
            return run
        return make

    instruments = [(fa, "patch_attention", counting_plain(plain_calls)),
                   (PointTransformerV3, "precompute_geometry", recording_drops(drops)),
                   (SemSegTester, "test", timed("test", sync=True)),
                   (datasets.DefaultDataset, "get", timed("data")),
                   (SemSegTester, "_test_scenes", timed("scene", sync=True)),
                   (SemSegTester, "predict_fragment", timed("fragments", sync=True)),
                   (SemSegTester, "forward_fragment", recording_forward(
                       torch, frags, plain_calls, lambda: dict(drops=drops[0])))]
    cuda_build.reset_launch_counts()
    with patched(*instruments):
        tester = test_tool.main(argv)
    launches = fa.patch_attention_fwd.launches
    n_frag = len(scene["fragment_list"])
    paths = {}
    for f in frags:
        path = "parity tables" if sum(f["drops"]) == 0 else "sorted tables"
        paths[path] = paths.get(path, 0) + 1
    runs = []  # consecutive fragments of one augmentation often repeat
    for f in frags:
        key = [f["bucket"], f["points"], f["drops"]]
        if runs and runs[-1][:3] == key:
            runs[-1][3] += 1
        else:
            runs.append(key + [1])
    print("test fragments [bucket, points, dropped per level, count] "
          + json.dumps(runs), flush=True)
    print(f"test {len(frags)} fragments: attention launches per fragment "
          f"{sorted({f['launches'] for f in frags})} (expected {n_launches}), "
          f"plain attention calls {sum(f['plain'] for f in frags)}, launches in all "
          f"{launches}; dropped per level, most over fragments "
          f"{np.max([f['drops'] for f in frags], axis=0).tolist()}; path {paths}",
          flush=True)
    if len(frags) != n_frag or launches != n_launches * n_frag:
        fail(f"the tester ran {len(frags)} fragments and {launches} launches, "
             f"expected {n_frag} and {n_launches * n_frag}")
    bad = [i for i, f in enumerate(frags)
           if f["launches"] != n_launches or f["plain"] or not f["finite"]]
    if bad:
        fail(f"fragments {bad[:5]}: wrong launch count, plain attention or "
             "non-finite logits")
    if not covered.all():
        fail(f"{int((~covered).sum())} raw points have no prediction")

    name = "scene0000_00"
    pred = np.load(os.path.join(save, "result", f"{name}_pred.npy"))
    submitted = np.loadtxt(os.path.join(save, "submit", f"{name}.txt"), dtype=np.int64)
    result = tester.result
    print(f"test result {json.dumps(result)}; pred {pred.shape}, submission lines "
          f"{submitted.shape[0]}", flush=True)
    if pred.shape != (n_raw,) or submitted.shape != (n_raw,):
        fail("the prediction or the submission does not cover every raw point")
    if not np.isin(submitted, datasets.VALID_CLASS_IDS_20).all():
        fail("the submission holds ids outside VALID_CLASS_IDS_20")
    if not all(0.0 <= v <= 1.0 for v in result.values()):
        fail(f"metrics out of [0, 1]: {result}")

    # the cached rerun reads result/<scene>_pred.npy and launches nothing
    cuda_build.reset_launch_counts()
    plain_calls[0] = 0
    with patched(instruments[0]):
        rerun = test_tool.main(argv)
    cached = dict(launches=fa.patch_attention_fwd.launches, plain=plain_calls[0],
                  same=all(np.array_equal(rerun.records[name][k], tester.records[name][k])
                           for k in ("intersection", "union", "target"))
                  and rerun.result == result)
    print(f"test cached rerun {json.dumps(cached)}", flush=True)
    if cached != dict(launches=0, plain=0, same=True):
        fail(f"the cached rerun differs or runs a forward: {cached}")
    del rerun

    # route gap: the same fragments and noise through the plain attention
    plain_cfg = copy.deepcopy(cfg)
    plain_cfg["backbone"]["use_pallas"] = False
    plain_model = build_model(plain_cfg, device="cuda")
    plain_model.load_state_dict(tester.model.state_dict())
    plain_tester = SemSegTester(tester.cfg, model=plain_model)
    gen = torch.Generator(device="cuda").manual_seed(5)
    gaps = []
    for i in (0, n_frag - 1):
        frag = scene["fragment_list"][i]
        bucket = pick_bucket(len(frag["coord"]), DEFAULT_BUCKETS)
        noise = torch.randn((bucket, 6), generator=gen, device="cuda")
        noise_fn = lambda index, b, c: noise
        pk = tester.predict_fragment(frag, i, noise_fn)
        pp = plain_tester.predict_fragment(frag, i, noise_fn)
        gaps.append(dict(fragment=i, max_abs_dp=(pk - pp).abs().max().item(),
                         argmax_agree=(pk.argmax(1) == pp.argmax(1)).float().mean().item()))
        print(f"test route gap {json.dumps(gaps[-1])}", flush=True)
    del plain_tester, plain_model
    torch.cuda.empty_cache()
    if any(g["max_abs_dp"] > TOL_TEST[0] or g["argmax_agree"] < TOL_TEST[1] for g in gaps):
        fail("tester probabilities through the kernel disagree with the plain route")

    ssi_ms = [f["ms"] for f in frags]
    forward_s = sum(ssi_ms) / 1e3
    split = dict(
        scene_s=times["test"], data_s=times["data"], forward_s=forward_s,
        fragment_prep_s=times["fragments"] - forward_s,
        # the scene loop less its data and fragments: votes, argmax, cache
        votes_argmax_s=times["scene"] - times["data"] - times["fragments"],
        other_s=times["test"] - times["scene"],
        ssi_ms_median=statistics.median(ssi_ms),
        ssi_ms_quartiles=statistics.quantiles(ssi_ms, n=4),
        fragments=n_frag, raw_points=n_raw,
        fragments_per_s=n_frag / times["test"], points_per_s=n_raw / times["test"],
        launches=launches, per_fragment=n_launches, route_gaps=gaps, card=card)
    print("test " + json.dumps(split), flush=True)
    return split


def eval_levels(torch, config, model, tmp, depth):
    """The pyramid of the trainer's validation batch: phase 8's room through
    the config's val pipeline into the `EvalLoader`'s bucket."""
    from cdsegnet_torch.data.datasets import build_dataset
    from cdsegnet_torch.data.loader import EvalLoader
    from cdsegnet_torch.engine.config import Config
    from cdsegnet_torch.engine.state import batch_to_point

    cfg = Config.fromfile(config)
    val = dict(cfg.data.val, data_root=os.path.join(tmp, "data"))
    batch, _ = next(iter(EvalLoader(build_dataset(val), num_points=EVAL_POINTS)))
    levels, _ = model.backbone.precompute_geometry(
        batch_to_point(batch, depth, 1, "cuda"))
    drops = [lv.dropped for lv in levels[1:]]
    print(f"eval batch: {int(batch['mask'].sum())} points in the {EVAL_POINTS} bucket, "
          f"level sizes {[lv.size for lv in levels]}, dropped per level {drops}",
          flush=True)
    if drops != [0, 0, 0, 0]:
        fail("the validation batch drops points")
    return levels


class Stopped(Exception):
    """Raised by the `ChipSmokeStop` hook: the interrupted training run."""


def phase_train_cli(torch, config, tmp, n_launches, n_eval_launches, card):
    """The trainer through its CLI entry point, stopped after epoch 1 and
    resumed; see the module docstring (phase 9)."""
    from cdsegnet_torch.data import datasets, transforms
    from cdsegnet_torch.engine import hooks, train as train_mod
    from cdsegnet_torch.engine.checkpoint import CheckpointManager
    from cdsegnet_torch.ops import flash_attention as fa
    from cdsegnet_torch.tools import train as train_tool
    from cdsegnet_torch.utils import cuda_build
    from cdsegnet_torch.utils.synthetic import room_scene

    start = time.perf_counter()
    if not transforms._HAVE_SCIPY:
        fail("scipy is missing: ElasticDistortion of the train pipeline would do nothing")
    torch.cuda.reset_peak_memory_stats()
    os.makedirs(os.path.join(tmp, "data", "train"))
    for i, seed in enumerate(TRAIN_ROOM_SEEDS):
        torch.save(room_scene(seed), os.path.join(tmp, "data", "train", f"scene{i:04d}_00.pth"))
    save = os.path.join(tmp, "train")
    records = dict(steps=[], evals=[], scenes=[], saves=[], epochs=[], began=[])
    plain_calls = [0]
    counts = lambda: dict(fwd=fa.patch_attention_fwd.launches,
                          fwd_lse=fa.patch_attention_fwd.lse_launches,
                          bwd_dq=fa.patch_attention_bwd_dq.launches,
                          bwd_dkdv=fa.patch_attention_bwd_dkdv.launches)

    def measured(kind):
        """Wrap the step a ``make_*_step`` returns: synchronized host-clock
        ms, launches and plain calls of each call."""
        def make(factory):
            def build(*args, **kwargs):
                step = factory(*args, **kwargs)

                @functools.wraps(step)  # keeps the step's attributes (its generators)
                def run(*a, **kw):
                    torch.cuda.synchronize()
                    before, plain = counts(), plain_calls[0]
                    t0 = time.perf_counter()
                    out = step(*a, **kw)
                    torch.cuda.synchronize()
                    rec = dict(ms=(time.perf_counter() - t0) * 1e3, plain=plain_calls[0] - plain,
                               launches={k: v - before[k] for k, v in counts().items()})
                    if kind == "evals":
                        mask = torch.as_tensor(a[0]["mask"], device="cuda")
                        rec.update(slots=int(mask.numel()), points=int(mask.sum().item()),
                                   finite=bool(torch.isfinite(out["seg_logits"][mask]).all()))
                    records[kind].append(rec)
                    return out
                return run
            return build
        return make

    def timed_scene(fn):
        def run(self, idx, rng):
            t0 = time.perf_counter()
            out = fn(self, idx, rng)
            if self.split == "train":
                records["scenes"].append(time.perf_counter() - t0)
            return out
        return run

    def timed_save(fn):
        def run(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            records["saves"].append(time.perf_counter() - t0)
            return out
        return run

    class ChipSmokeProbe(hooks.HookBase):
        """Reads the trainer: where each epoch began, each step's metrics,
        data wait and learning rates, each epoch's end state."""

        def before_epoch(self):
            tr = self.trainer
            records["trainer"] = tr
            records["began"].append(dict(
                epoch=tr.epoch, step=tr.step, count=tr.optimizer.count,
                generators={k: g.get_state() for k, g in tr.generators.items()}))

        def after_step(self):
            tr = self.trainer
            timer = next(h for h in tr.hooks if isinstance(h, hooks.IterationTimer))
            records["steps"][-1].update(
                metrics=dict(tr.comm_info["metrics"]), data_s=timer.data_m.val,
                batch_s=timer.batch_m.val, step=tr.step,
                lrs=[g["lr"] for g in tr.optimizer.opt.param_groups],
                want_lrs=[s(tr.step - 1) for s in tr.optimizer.schedules])

        def after_epoch(self):
            tr = self.trainer
            records["epochs"].append(dict(
                epoch=tr.epoch, step=tr.step, miou=tr.comm_info.get("current_metric_value"),
                generators={k: g.get_state() for k, g in tr.generators.items()}))

    class ChipSmokeStop(hooks.HookBase):
        def after_epoch(self):
            if self.trainer.epoch == 0:
                raise Stopped("stopped after epoch 1")

    hook_cfg = [dict(type="CheckpointLoader"), dict(type="IterationTimer", warmup_iter=2),
                dict(type="InformationWriter", log_interval=1),
                dict(type="SemSegEvaluator"), dict(type="CheckpointSaver", save_freq=1),
                dict(type="ChipSmokeProbe"), dict(type="ChipSmokeStop"),
                dict(type="PreciseEvaluator")]
    data_root = os.path.join(tmp, "data")
    argv = ["--config-file", config, "--options", "epoch=2", "eval_epoch=2",
            "save_freq_threshold=1", f"save_path={save}", f"hooks={hook_cfg!r}",
            f"data.train.data_root={data_root}", f"data.val.data_root={data_root}",
            f"data.test.data_root={data_root}"]
    instruments = [(fa, "patch_attention", counting_plain(plain_calls)),
                   (train_mod, "make_train_step", measured("steps")),
                   (train_mod, "make_eval_step", measured("evals")),
                   (datasets.DefaultDataset, "prepare_train_data", timed_scene),
                   (CheckpointManager, "save_epoch", timed_save)]
    hooks.HOOKS.register_module("ChipSmokeProbe", ChipSmokeProbe)
    hooks.HOOKS.register_module("ChipSmokeStop", ChipSmokeStop)
    runs = {}
    with patched(*instruments):
        for name, extra in (("interrupted", []), ("resumed", ["resume=True"])):
            cuda_build.reset_launch_counts()
            plain_calls[0] = 0
            t0 = time.perf_counter()
            try:
                train_tool.main(argv + extra)
                stopped = False
            except Stopped:
                stopped = True
            torch.cuda.synchronize()
            runs[name] = dict(wall_s=time.perf_counter() - t0, stopped=stopped,
                              launches=counts(), plain=plain_calls[0],
                              files=sorted(os.listdir(os.path.join(save, "model"))))
            print(f"train cli run {name} " + json.dumps(runs[name]), flush=True)
    trainer = records.pop("trainer")

    steps, evals = records["steps"], records["evals"]
    print("train cli steps " + json.dumps(steps), flush=True)
    print("train cli evals " + json.dumps(evals), flush=True)
    want_steps = dict(fwd=n_launches, fwd_lse=n_launches, bwd_dq=n_launches,
                      bwd_dkdv=n_launches)
    if runs["interrupted"]["stopped"] is not True or runs["resumed"]["stopped"]:
        fail(f"the first run did not stop after epoch 1 or the second did: {runs}")
    if runs["interrupted"]["files"] != ["epoch_1", "model_best", "model_last"]:
        fail(f"checkpoints after the interrupted run: {runs['interrupted']['files']}")
    if runs["resumed"]["files"] != ["epoch_1", "epoch_2", "model_best", "model_last"]:
        fail(f"checkpoints after the resumed run: {runs['resumed']['files']}")
    if len(steps) != 4 or any(s["launches"] != want_steps or s["plain"] for s in steps):
        fail(f"training steps: {len(steps)}, expected 4 of {want_steps} launches "
             "and no plain attention")
    bad = [s for s in steps if not np.isfinite(s["metrics"]["loss"])
           or any(v for k, v in s["metrics"].items() if k.startswith("dropped_l"))]
    if bad:
        fail(f"training steps with a non-finite loss or dropped points: {bad}")
    if [s["step"] for s in steps] != [1, 2, 3, 4]:
        fail(f"optimizer steps {[s['step'] for s in steps]}")
    if any(s["lrs"] != s["want_lrs"] for s in steps):
        fail("a step's learning rates are not OneCycle's at its count")
    eval_launches = dict(fwd=n_eval_launches, fwd_lse=0, bwd_dq=0, bwd_dkdv=0)
    if len(evals) != 2 or any(e["launches"] != eval_launches or e["plain"]
                              or not e["finite"] or e["slots"] != EVAL_POINTS
                              for e in evals):
        fail(f"validation SSIs: expected 2 of {eval_launches} launches at "
             f"{EVAL_POINTS} slots, finite, no plain attention")
    began, ends = records["began"], records["epochs"]
    resumed = began[1]
    if (resumed["epoch"], resumed["step"], resumed["count"]) != (1, 2, 2) or \
            trainer.start_epoch != 1:
        fail(f"the resumed run began at epoch {resumed['epoch']}, step {resumed['step']}, "
             f"count {resumed['count']}")
    if any(not torch.equal(resumed["generators"][k], g)
           for k, g in ends[0]["generators"].items()):
        fail("the resumed run's generators are not those saved after epoch 1")
    if not all(e["miou"] is not None and 0.0 <= e["miou"] <= 1.0 for e in ends):
        fail(f"val mIoU out of [0, 1]: {[e['miou'] for e in ends]}")
    metric_lines = open(os.path.join(save, "metrics.jsonl")).read().splitlines()
    tb_dir = os.path.join(save, "tb")
    tb_sizes = [os.path.getsize(os.path.join(tb_dir, f)) for f in os.listdir(tb_dir)]
    if len(metric_lines) != 4 or not tb_sizes or sum(tb_sizes) < 500:
        fail(f"metrics.jsonl lines {len(metric_lines)}, event files {tb_sizes}")
    tester = trainer.hooks[-1].tester
    if sorted(tester.records) != ["scene0000_00"] or not all(
            0.0 <= v <= 1.0 for v in tester.result.values()):
        fail("the precise evaluator gave no record of the val room")

    result = dict(
        step_ms=[s["ms"] for s in steps], batch_s=[s["batch_s"] for s in steps],
        data_wait_s=[s["data_s"] for s in steps], losses=[s["metrics"]["loss"] for s in steps],
        valid_points=[s["metrics"]["valid_points"] for s in steps],
        scene_pipeline_s=records["scenes"],
        scene_pipeline_s_median=statistics.median(records["scenes"]),
        eval_ssi_ms=[e["ms"] for e in evals], eval_points=[e["points"] for e in evals],
        val_miou=[e["miou"] for e in ends], save_s=records["saves"],
        precise=dict(tester.result, launches=runs["resumed"]["launches"]["fwd"]
                     - 2 * n_launches - n_eval_launches),
        runs_wall_s={k: r["wall_s"] for k, r in runs.items()},
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
        launches_per_step=steps[0]["launches"], launches_per_eval=evals[0]["launches"]["fwd"],
        phase_s=time.perf_counter() - start, card=card)
    print("train cli " + json.dumps(result), flush=True)
    return result


def config_path(name: str) -> str:
    return os.path.join(ROOT, "configs", name)


def load_config(name: str):
    """``configs/<name>`` through the port's `Config` (its ``_base_`` chain
    merged)."""
    from cdsegnet_torch.engine.config import Config

    return Config.fromfile(config_path(name))


def set_attention_route(model, use_pallas):
    """Every self-attention of ``model`` through the kernel (None) or the
    plain version (False): one set of weights on both routes."""
    for m in model.modules():
        if hasattr(m, "use_pallas"):
            m.use_pallas = use_pallas


def counting_plain(plain_calls):
    """A `patched` factory that counts the calls of the plain attention."""
    def make(fn):
        def run(*args, **kwargs):
            plain_calls[0] += 1
            return fn(*args, **kwargs)
        return run
    return make


def recording_drops(drops):
    """A `patched` factory for `precompute_geometry`: keeps the last
    pyramid's drops per pooled level in ``drops[0]``."""
    def make(fn):
        def run(self, point, *args, **kwargs):
            levels, stem = fn(self, point, *args, **kwargs)
            drops[0] = [int(lv.dropped) for lv in levels[1:]]
            return levels, stem
        return run
    return make


def recording_forward(torch, frags, plain_calls, extra=dict):
    """A `patched` factory for `SemSegTester.forward_fragment`: appends each
    call's bucket, valid points, synchronized host ms, kernel launches,
    plain attention calls and finiteness, and ``extra()``, to ``frags``."""
    from cdsegnet_torch.ops import flash_attention as fa

    def make(fn):
        def run(self, point, noise):
            torch.cuda.synchronize()
            before, plain = fa.patch_attention_fwd.launches, plain_calls[0]
            t0 = time.perf_counter()
            logits = fn(self, point, noise)
            torch.cuda.synchronize()
            frags.append(dict(
                bucket=point.num_points, points=int(point.mask.sum().item()),
                ms=(time.perf_counter() - t0) * 1e3,
                launches=fa.patch_attention_fwd.launches - before,
                plain=plain_calls[0] - plain,
                finite=bool(torch.isfinite(logits[point.mask]).all().item()), **extra()))
            return logits
        return run
    return make


def launch_sums(rows, launches):
    """`forward_sums` of phase 3 rows over ``launches``, another model's
    forward on the same levels (each launch's row by level, curve order,
    heads and head dim)."""
    counts = collections.Counter(launches)
    key = lambda r: (r["level"], r["order"], r["shape"][1], r["shape"][2])
    return forward_sums([dict(r, launches_per_ssi=counts[key(r)])
                         for r in rows if counts[key(r)]])


def train_launch_sums(rows, launches, direction):
    """`step_sums` of phase 5 rows over another model's training
    ``launches`` (each launch's row by level, heads and head dim)."""
    counts = collections.Counter((lv, h, d) for lv, _, h, d in launches)
    key = lambda r: (r["level"], r["shape"][1], r["shape"][2])
    return step_sums([dict(r, launches_per_step=counts[key(r)])
                      for r in rows if counts[key(r)]], direction)


def nuscenes_data(torch, tmp, depth):
    """Write the sweeps (`lidar_sweep`, seeds ``SWEEP_SEEDS``) as the train
    and val splits of ``<tmp>/nuscenes``; return the root, the training
    batch (the shipped train pipeline, two sweeps in the 204,800-slot
    bucket) and the SSI batch (the val pipeline's first sweep in its
    bucket), both at ``depth``."""
    from cdsegnet_torch.data.collate import collate_scenes, pick_bucket
    from cdsegnet_torch.data.datasets import build_dataset
    from cdsegnet_torch.engine.state import batch_to_point
    from cdsegnet_torch.engine.test import DEFAULT_BUCKETS
    from cdsegnet_torch.utils.synthetic import lidar_sweep, write_nuscenes

    conf = load_config(NUSCENES)
    root = os.path.join(tmp, "nuscenes")
    sweeps = [lidar_sweep(s) for s in SWEEP_SEEDS]
    write_nuscenes(root, dict(train=sweeps, val=sweeps))
    rng = np.random.default_rng(conf.seed)
    train = build_dataset(dict(conf.data.train, data_root=root))
    scenes = [train.get(i, rng) for i in range(len(SWEEP_SEEDS))]
    train_batch = collate_scenes(scenes, conf.bucket_num_points, conf.scenes_per_device)
    val = build_dataset(dict(conf.data.val, data_root=root)).get(0, rng)
    bucket = pick_bucket(len(val["coord"]), DEFAULT_BUCKETS)
    print(f"nuscenes sweeps {[len(s['points']) for s in sweeps]} raw points; train "
          f"pipeline {[len(s['coord']) for s in scenes]} points in the "
          f"{conf.bucket_num_points} bucket; val pipeline {len(val['coord'])} points in "
          f"the {bucket} bucket", flush=True)
    return (root, batch_to_point(train_batch, depth, conf.scenes_per_device, "cuda"),
            batch_to_point(collate_scenes([val], bucket, 1), depth, 1, "cuda"))


def phase_variants(torch, ssi_point, gap_point, train_point, nus, card):
    """Each model variant of `VARIANTS` at the full width of its config
    (random weights from seed 0): one SSI (launches, plain calls, finite
    logits, host ms), the SSI route gap against the plain attention route
    (TOL_TEST on softmax probabilities), then one training step of its
    optimizer (launches, loss, drops per level) and a second, timed. ScanNet
    models run phase 4's scene, the 32,768-slot gap scene and phase 6's
    bucket; the nuScenes model its sweeps (``nus``). Built and freed one at
    a time."""
    from cdsegnet_torch.engine.optimizer import build_optimizer
    from cdsegnet_torch.engine.state import make_train_step
    from cdsegnet_torch.models.builder import build_model, build_model_criteria
    from cdsegnet_torch.models.segmentor import CNFSegmentor
    from cdsegnet_torch.ops import flash_attention as fa
    from cdsegnet_torch.utils import cuda_build

    _, nus_train, nus_ssi = nus
    plain_calls = [0]
    results = {}
    for name in VARIANTS:
        start = time.perf_counter()
        conf = load_config(name)
        cfg = copy.deepcopy(conf.model)
        want_step, want_ssi = VARIANT_LAUNCHES[name]
        counted = (len(attention_launches(cfg["backbone"], c_decoder=True)),
                   len(attention_launches(cfg["backbone"])))
        if counted != (want_step, want_ssi):
            fail(f"{name}: the config gives {counted} launches per step and SSI")
        on_sweep = name == NUSCENES
        point = nus_ssi if on_sweep else ssi_point
        gen = torch.Generator(device="cuda").manual_seed(7)
        c_in = cfg.get("c_in_channels", 6)
        noise = torch.randn((point.num_points, c_in), generator=gen, device="cuda")
        model = build_model(cfg, device="cuda", generator=torch.Generator().manual_seed(0))
        cnf = isinstance(model, CNFSegmentor)

        @torch.no_grad()
        def ssi(pt, nz):
            if cnf:
                return model.inference(pt, noise=nz)["seg_logits"]
            return model(pt)["n_pred"]

        cuda_build.reset_launch_counts()
        plain_calls[0] = 0
        with patched((fa, "patch_attention", counting_plain(plain_calls))):
            logits = ssi(point, noise)
            torch.cuda.synchronize()
            ssi_counts = dict(fwd=fa.patch_attention_fwd.launches, plain=plain_calls[0])
            times = []
            for _ in range(4):  # 1 warm-up, then the median of 3
                t0 = time.perf_counter()
                ssi(point, noise)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
        valid = point.mask
        if ssi_counts != dict(fwd=want_ssi, plain=0):
            fail(f"{name}: SSI launches {ssi_counts}, expected {want_ssi} and no plain")
        if tuple(logits.shape) != (point.num_points, conf.data.num_classes) or \
                not torch.isfinite(logits[valid]).all():
            fail(f"{name}: SSI logits {tuple(logits.shape)} not finite or misshapen")

        # route gap: the same weights and noise through the plain attention
        gp = nus_ssi if on_sweep else gap_point
        gnoise = torch.randn((gp.num_points, c_in), generator=gen, device="cuda")
        pk = torch.softmax(ssi(gp, gnoise).float(), -1)[gp.mask]
        set_attention_route(model, False)
        pp = torch.softmax(ssi(gp, gnoise).float(), -1)[gp.mask]
        set_attention_route(model, None)
        gap = dict(max_abs_dp=(pk - pp).abs().max().item(),
                   argmax_agree=(pk.argmax(1) == pp.argmax(1)).float().mean().item(),
                   slots=gp.num_points)
        del pk, pp
        if gap["max_abs_dp"] > TOL_TEST[0] or gap["argmax_agree"] < TOL_TEST[1]:
            fail(f"{name}: SSI through the kernel disagrees with the plain route {gap}")
        if on_sweep:
            from cdsegnet_torch.engine.checkpoint import CheckpointManager, snapshot

            CheckpointManager(os.path.join(nus[0], "exp", "model")).save(
                snapshot(model), "model_last")

        # training: the config's optimizer, shuffled curves, drop_path
        model.train()
        opt = build_optimizer(dict(conf.optimizer), model, dict(conf.scheduler),
                              total_steps=TRAIN_TOTAL_STEPS,
                              param_dicts=[dict(p) for p in conf.param_dicts],
                              clip_keywords=conf.get("gredient_clip", []), device="cuda")
        step = make_train_step(model, build_model_criteria(cfg), opt, seed=0, device="cuda")
        tp = nus_train if on_sweep else train_point
        cuda_build.reset_launch_counts()
        plain_calls[0] = 0
        with patched((fa, "patch_attention", counting_plain(plain_calls))):
            torch.cuda.reset_peak_memory_stats()
            metrics = step(tp)
            torch.cuda.synchronize()
            step_counts = dict(fwd=fa.patch_attention_fwd.launches,
                               fwd_lse=fa.patch_attention_fwd.lse_launches,
                               bwd_dq=fa.patch_attention_bwd_dq.launches,
                               bwd_dkdv=fa.patch_attention_bwd_dkdv.launches,
                               plain=plain_calls[0])
            t0 = time.perf_counter()
            metrics2 = step(tp)
            torch.cuda.synchronize()
            step_ms = (time.perf_counter() - t0) * 1e3
        want = dict(fwd=want_step, fwd_lse=want_step, bwd_dq=want_step,
                    bwd_dkdv=want_step, plain=0)
        losses = [metrics["loss"].item(), metrics2["loss"].item()]
        drops = [int(metrics[f"dropped_l{i}"]) for i in range(1, 5)]
        result = dict(ssi_launches=ssi_counts["fwd"], ssi_ms=statistics.median(times[1:]),
                      ssi_ms_all=times, ssi_slots=point.num_points,
                      ssi_valid=int(valid.sum().item()), route_gap=gap,
                      step_launches=step_counts, losses=losses, dropped_per_level=drops,
                      step_slots=tp.num_points, step_valid=int(tp.mask.sum().item()),
                      second_step_ms=step_ms,
                      peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                      phase_s=time.perf_counter() - start, card=card)
        print(f"variant {name} " + json.dumps(result), flush=True)
        if step_counts != want:
            fail(f"{name}: the training step launched {step_counts}, expected {want}")
        if not np.isfinite(losses).all():
            fail(f"{name}: non-finite training loss {losses}")
        results[name] = result
        del model, opt, step, logits, metrics, metrics2
        torch.cuda.empty_cache()
    return results


def phase_nuscenes_test(torch, nus, n_launches, card):
    """The tester through its CLI entry point on the two sweeps with the
    nuScenes config and the checkpoint phase 10 saved: every fragment
    ``n_launches`` launches and no plain attention, a lidarseg submission
    file per sweep with a label in 1-16 for every raw point."""
    from cdsegnet_torch.engine.test import SemSegTester
    from cdsegnet_torch.ops import flash_attention as fa
    from cdsegnet_torch.tools import test as test_tool

    root = nus[0]
    save = os.path.join(root, "exp")
    frags, plain_calls = [], [0]

    argv = ["--config-file", config_path(NUSCENES), "--checkpoint",
            "model_last", "--options", f"data.test.data_root={root}", f"save_path={save}",
            "submission=True"]
    t0 = time.perf_counter()
    with patched((fa, "patch_attention", counting_plain(plain_calls)),
                 (SemSegTester, "forward_fragment",
                  recording_forward(torch, frags, plain_calls))):
        tester = test_tool.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    sub = os.path.join(save, "submit", "lidarseg", "test")
    files = sorted(os.listdir(sub))
    labels = {f: np.fromfile(os.path.join(sub, f), np.uint8) for f in files}
    raw = [len(np.fromfile(os.path.join(root, "raw", "samples", "LIDAR_TOP", f"val{i}.bin"),
                           np.float32)) // 5 for i in range(len(SWEEP_SEEDS))]
    result = dict(fragments=len(frags), per_fragment=sorted({f["launches"] for f in frags}),
                  plain=sum(f["plain"] for f in frags),
                  buckets=sorted({f["bucket"] for f in frags}),
                  points=[f["points"] for f in frags], files=files,
                  labels_per_file=[len(v) for v in labels.values()], raw_points=raw,
                  result=tester.result, wall_s=wall, card=card)
    print("nuscenes test " + json.dumps(result), flush=True)
    if not frags or result["per_fragment"] != [n_launches] or result["plain"] or \
            not all(f["finite"] for f in frags):
        fail(f"nuScenes tester: launches per fragment {result['per_fragment']}, expected "
             f"{n_launches}; plain calls {result['plain']}; or non-finite logits")
    if files != [f"val{i}_lidarseg.bin" for i in range(len(SWEEP_SEEDS))] or \
            result["labels_per_file"] != raw or \
            not all(1 <= v.min() and v.max() <= 16 for v in labels.values()):
        fail(f"nuScenes submission: {files}, {result['labels_per_file']} labels for "
             f"{raw} raw points, or labels outside 1-16")
    if not all(0.0 <= v <= 1.0 for v in tester.result.values()):
        fail(f"nuScenes metrics out of [0, 1]: {tester.result}")
    return result


def time_rooms(tmp):
    """Write the timing protocol's rooms (`TIME_ROOMS`) as
    ``<tmp>/time/val``; return the data root."""
    import torch

    from cdsegnet_torch.utils.synthetic import room_scene

    root = os.path.join(tmp, "time")
    os.makedirs(os.path.join(root, "val"))
    for i, room in enumerate(TIME_ROOMS):
        torch.save(room_scene(**room), os.path.join(root, "val", f"scene{i:04d}_00.pth"))
    return root


def time_fragments(root):
    """The whole-scene fragment of each room: `TIME_CONFIG`'s test pipeline
    with one identity pass (its shipped ``aug_transform=[]`` gives none).
    The 0.1 mm test grid keeps every point; a room where some voxel holds
    two points gives a second fragment of the same size (test-mode sampling
    cycles through each voxel's points), and its first is returned."""
    from cdsegnet_torch.data.datasets import build_dataset

    conf = load_config(TIME_CONFIG)
    test = copy.deepcopy(dict(conf.data.test, data_root=root))
    test["test_cfg"]["aug_transform"] = [[]]
    ds = build_dataset(test)
    rng = np.random.default_rng(conf.seed)
    out = []
    for i in range(len(ds)):
        scene = ds.get(i, rng)
        sizes = sorted((len(f["coord"]) for f in scene["fragment_list"]), reverse=True)
        print(f"time scene {scene['name']}: {scene['segment'].size} raw points, "
              f"fragments of {sizes} points", flush=True)
        if sizes[0] < 0.99 * scene["segment"].size:
            fail(f"{scene['name']}: no whole-scene fragment")
        out.append(scene["fragment_list"][0])
    return out


def phase_time(torch, config, root, ckpt, n_launches, card):
    """`tools/test_time.py` at its defaults, then the tester CLI with the
    timing config on the two rooms: as shipped (no pass: no fragment) and
    with one identity pass at serialization depth 12 (as shipped) and 16.
    Prints each whole-scene fragment's bucket, largest grid coordinate,
    pyramid path (packed sorts or their fallback) and drops per level, and
    its SSI host ms."""
    import warnings

    from cdsegnet_torch.engine.test import SemSegTester
    from cdsegnet_torch.models.ptv3 import PointTransformerV3
    from cdsegnet_torch.ops import flash_attention as fa
    from cdsegnet_torch.tools import test as test_tool
    from cdsegnet_torch.tools import test_time
    from cdsegnet_torch.utils import cuda_build

    plain_calls = [0]
    cuda_build.reset_launch_counts()
    with patched((fa, "patch_attention", counting_plain(plain_calls))):
        timing = test_time.main(["--config-file", config])
    timing.update(launches=fa.patch_attention_fwd.launches, plain=plain_calls[0])
    print("time tool " + json.dumps(timing), flush=True)
    if timing["launches"] != 11 * n_launches or timing["plain"]:
        fail(f"test_time: {timing['launches']} launches, expected 11 x {n_launches}, "
             "and no plain attention")

    runs = {}
    for run, depth, passes in (("shipped", 12, None), ("depth12", 12, [[]]),
                               ("depth16", 16, [[]])):
        frags, drops, grid_max = [], [None], [None]

        def predict(fn):
            def p(self, frag, *args, **kwargs):
                grid_max[0] = int(frag["grid_coord"].max())
                return fn(self, frag, *args, **kwargs)
            return p

        opts = [f"data.test.data_root={root}", f"save_path={os.path.join(root, run)}",
                f"serialization_depth={depth}"]
        if passes is not None:
            opts.append(f"data.test.test_cfg.aug_transform={passes!r}")
        argv = ["--config-file", config_path(TIME_CONFIG),
                "--checkpoint", ckpt, "--options"] + opts
        with warnings.catch_warnings(record=True) as caught, patched(
                (fa, "patch_attention", counting_plain(plain_calls)),
                (PointTransformerV3, "precompute_geometry", recording_drops(drops)),
                (SemSegTester, "predict_fragment", predict),
                (SemSegTester, "forward_fragment", recording_forward(
                    torch, frags, plain_calls,
                    lambda: dict(grid_max=grid_max[0], dropped_per_level=drops[0])))):
            warnings.simplefilter("always")
            t0 = time.perf_counter()
            tester = test_tool.main(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        fallback = sum("packed sort" in str(w.message) for w in caught)
        runs[run] = dict(depth=depth, fragments=frags, wall_s=wall,
                         packed_sort_fallbacks=fallback,
                         path="packed sorts" if not fallback else "packed-sort fallback",
                         result=tester.result, card=card)
        print(f"time tester {run} " + json.dumps(runs[run]), flush=True)
        if passes is None:
            if frags:
                fail("the shipped timing config ran a fragment; its aug_transform=[] "
                     "gives none")
            continue
        # whole-scene fragments (two per room where a 0.1 mm voxel holds two
        # points) in the rooms' buckets
        if sorted({f["bucket"] for f in frags}) != sorted(TIME_BUCKETS) or any(
                f["launches"] != n_launches or f["plain"] or not f["finite"] for f in frags):
            fail(f"timing protocol {run}: expected whole-scene fragments in the buckets "
                 f"{TIME_BUCKETS}, {n_launches} launches each, no plain attention, finite")
        if bool(fallback) != (depth == 16) or not all(f["grid_max"] > 4095 for f in frags):
            fail(f"timing protocol {run}: the packed sorts fell back {fallback} times "
                 "(expected only at depth 16), or the grid stayed within 12 bits")
    return runs


def phase_ddim(torch, config, cfg, tmp, ckpt, n_launches, card):
    """MSAI (``inference_step=5``) through the tester CLI on phase 8's room
    with the first augmentation only: every fragment takes 6 forwards of
    ``n_launches`` launches (the c-decoder included), no plain attention.
    Then MSFI on its first fragment, and that fragment's MSAI logits through
    the kernel against the plain attention route (``TOL_DDIM``)."""
    from cdsegnet_torch.engine.test import SemSegTester
    from cdsegnet_torch.ops import flash_attention as fa
    from cdsegnet_torch.tools import test as test_tool
    from cdsegnet_torch.utils import cuda_build

    conf = load_config("scannet/cdsegnet.py")
    first_aug = [copy.deepcopy(conf.data.test.test_cfg.aug_transform[0])]
    save = os.path.join(tmp, "ddim")
    argv = ["--config-file", config, "--checkpoint", ckpt, "--options",
            f"data.test.data_root={os.path.join(tmp, 'data')}", f"save_path={save}",
            "inference_mode=MSAI", "inference_step=5",
            f"data.test.test_cfg.aug_transform={json.loads(json.dumps(first_aug))!r}"]
    frags, firsts, plain_calls = [], [], [0]

    def predict(fn):
        def p(self, frag, index, *args, **kwargs):
            if not firsts:
                firsts.append(frag)
            return fn(self, frag, index, *args, **kwargs)
        return p

    cuda_build.reset_launch_counts()
    t0 = time.perf_counter()
    with patched((fa, "patch_attention", counting_plain(plain_calls)),
                 (SemSegTester, "predict_fragment", predict),
                 (SemSegTester, "forward_fragment",
                  recording_forward(torch, frags, plain_calls))):
        tester = test_tool.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    lse = fa.patch_attention_fwd.lse_launches
    per = 6 * n_launches
    msai = dict(fragments=len(frags), per_fragment=sorted({f["launches"] for f in frags}),
                plain=sum(f["plain"] for f in frags), lse_launches=lse,
                buckets=sorted({f["bucket"] for f in frags}),
                ms_median=statistics.median(f["ms"] for f in frags),
                ms_all=[f["ms"] for f in frags], result=tester.result, wall_s=wall)
    print("ddim msai " + json.dumps(msai), flush=True)
    if not frags or msai["per_fragment"] != [per] or msai["plain"] or lse or \
            not all(f["finite"] for f in frags):
        fail(f"MSAI: launches per fragment {msai['per_fragment']}, expected {per}; plain "
             f"calls {msai['plain']}; lse launches {lse}; or non-finite logits")
    if not all(0.0 <= v <= 1.0 for v in tester.result.values()):
        fail(f"MSAI metrics out of [0, 1]: {tester.result}")

    # MSFI and the route gap on the first fragment, with one noise draw
    n_frag, point, noise = tester._prepare_fragment(firsts[0], 0, None)
    msfi_tester = SemSegTester(copy.deepcopy(tester.cfg), model=tester.model, device="cuda")
    msfi_tester.inference_mode = "MSFI"
    cuda_build.reset_launch_counts()
    t0 = time.perf_counter()
    final = msfi_tester.forward_fragment(point, noise)
    torch.cuda.synchronize()
    msfi = dict(launches=fa.patch_attention_fwd.launches,
                ms=(time.perf_counter() - t0) * 1e3,
                finite=bool(torch.isfinite(final[point.mask]).all().item()))
    got = tester.forward_fragment(point, noise)
    set_attention_route(tester.model, False)
    want = tester.forward_fragment(point, noise)
    set_attention_route(tester.model, None)
    valid = point.mask
    gap = dict(max_abs_dlogits=(got - want)[valid].abs().max().item(),
               max_abs_logits=want[valid].abs().max().item(),
               argmax_agree=(got.argmax(1) == want.argmax(1))[valid].float().mean().item(),
               points=n_frag)
    print(f"ddim msfi {json.dumps(msfi)}; msai route gap {json.dumps(gap)}", flush=True)
    if msfi["launches"] != per or not msfi["finite"]:
        fail(f"MSFI: {msfi['launches']} launches, expected {per}, or non-finite logits")
    if (gap["max_abs_dlogits"] > TOL_DDIM[0] * gap["max_abs_logits"]
            or gap["argmax_agree"] < TOL_DDIM[1]):
        fail(f"MSAI through the kernel disagrees with the plain route: {gap}")
    return dict(msai, msfi=msfi, route_gap=gap, per_fragment=per, card=card)


def phase_micro(torch, conf, cfg, micros, n_launches, peak_mb1, card):
    """Phase 13: the flagship training step with ``microbatch=2`` through
    `make_train_step`: two micro buckets of ``n_train / 2`` slots, one scene
    each, trained in turn (3 warm-ups, then 5 timed steps). Every step must
    launch each kernel twice per attention block, no plain attention; the
    loss finite, no point dropped. Prints the step time and the peak memory
    beside phase 6's at microbatch 1 (``peak_mb1``)."""
    from cdsegnet_torch.engine.state import make_train_step
    from cdsegnet_torch.ops import flash_attention as fa
    from cdsegnet_torch.utils import cuda_build

    start = time.perf_counter()
    torch.cuda.empty_cache()
    model, criteria, opt = train_setup(torch, conf, cfg)
    step = make_train_step(model, criteria, opt, seed=0, device="cuda", microbatch=2)
    plain_calls = [0]
    want = 2 * n_launches
    torch.cuda.reset_peak_memory_stats()
    times, losses, per_step = [], [], []
    with patched((fa, "patch_attention", counting_plain(plain_calls))):
        for i in range(8):  # 3 warm-ups, then 5 timed steps
            cuda_build.reset_launch_counts()
            plain_calls[0] = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m = step(micros)
            torch.cuda.synchronize()
            if i >= 3:
                times.append(time.perf_counter() - t0)
            losses.append(m["loss"].item())
            per_step.append(dict(fwd=fa.patch_attention_fwd.launches,
                                 fwd_lse=fa.patch_attention_fwd.lse_launches,
                                 bwd_dq=fa.patch_attention_bwd_dq.launches,
                                 bwd_dkdv=fa.patch_attention_bwd_dkdv.launches,
                                 plain=plain_calls[0],
                                 dropped=[int(m[f"dropped_l{k}"]) for k in range(1, 5)]))
    n_valid = sum(int(p.mask.sum().item()) for p in micros)
    step_ms = statistics.median(times) * 1e3
    result = dict(step_ms=step_ms, step_ms_all=[t * 1e3 for t in times],
                  points_per_s=n_valid / (step_ms / 1e3), n_valid=n_valid,
                  micro_slots=[p.num_points for p in micros], launches=per_step[0],
                  losses=losses, peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                  peak_mem_gib_microbatch1=peak_mb1,
                  phase_s=time.perf_counter() - start, card=card)
    print("micro " + json.dumps(result), flush=True)
    want_step = dict(fwd=want, fwd_lse=want, bwd_dq=want, bwd_dkdv=want, plain=0,
                     dropped=[0, 0, 0, 0])
    if any(c != want_step for c in per_step):
        fail(f"microbatch steps launched {per_step}, expected {want_step} each")
    if not np.isfinite(losses).all():
        fail(f"non-finite microbatch loss {losses}")
    del model, opt, step
    torch.cuda.empty_cache()
    return result


def _rank_setup():
    """A spawned rank of phase 14 on the card: the same math flags as the
    parent, deterministic kernels where PyTorch has them (an atomic
    scatter-add may otherwise sum in another order on each run)."""
    import torch

    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    deterministic(torch, True)
    return torch


def deterministic(torch, on: bool) -> None:
    """PyTorch's deterministic kernels on or off (warning, not failing, on an
    operation without one); uninitialized memory is left as it is, since
    the attention kernels write every row of their outputs."""
    import torch.utils.deterministic

    torch.use_deterministic_algorithms(on, warn_only=True)
    torch.utils.deterministic.fill_uninitialized_memory = False


def rank_train(argv, out_dir):
    """Phase 14a, one rank: the training CLI (`tools/train.py`'s `main`)
    inside the group `launch` built, with a hook that, after every step,
    compares this rank's parameters and running statistics with rank 0's
    (max |delta|, and bit for bit) and records the step's host-clock time
    and launches, and each epoch's summed validation histograms; and a hook
    that stops the run after epoch 1 where the hooks name it (each rank
    writes its records and waits for the other before raising)."""
    torch = _rank_setup()
    from cdsegnet_torch.engine import hooks
    from cdsegnet_torch.ops import flash_attention as fa
    from cdsegnet_torch.parallel import dist
    from cdsegnet_torch.tools import train as train_tool

    records = dict(steps=[], evals=[])
    counts = lambda: [fa.patch_attention_fwd.launches, fa.patch_attention_fwd.lse_launches,
                      fa.patch_attention_bwd_dq.launches, fa.patch_attention_bwd_dkdv.launches]

    class ChipSmokeRanks(hooks.HookBase):
        def before_step(self):
            torch.cuda.synchronize()
            self.t0, self.c0 = time.perf_counter(), counts()

        def after_step(self):
            tr = self.trainer
            torch.cuda.synchronize()
            ms = (time.perf_counter() - self.t0) * 1e3
            launches = [a - b for a, b in zip(counts(), self.c0)]
            flat = torch.cat([t.detach().reshape(-1).float() for t in
                              list(tr.model.parameters()) + list(tr.model.buffers())])
            ref = dist.broadcast_(flat.clone(), 0)
            records["steps"].append(dict(
                step=tr.step, ms=ms, launches=launches, loss=tr.comm_info["metrics"]["loss"],
                dropped=[tr.comm_info["metrics"].get(f"dropped_l{k}") for k in range(1, 5)],
                max_abs_diff=(flat - ref).abs().max().item(), equal=torch.equal(flat, ref)))

        def after_epoch(self):
            ev = next(h for h in self.trainer.hooks if isinstance(h, hooks.SemSegEvaluator))
            records["evals"].append(dict(epoch=self.trainer.epoch,
                                         histograms=ev.histograms.tolist()))

    def dump():
        records.update(peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                       backend=torch.distributed.get_backend(), warnings=caught)
        with open(os.path.join(out_dir, f"train_rank{dist.rank()}.json"), "w") as f:
            json.dump(records, f)

    class ChipSmokeStop(hooks.HookBase):
        def after_epoch(self):
            if self.trainer.epoch == 0:
                dump()
                dist.barrier()
                raise Stopped("stopped after epoch 1")

    hooks.HOOKS.register_module("ChipSmokeRanks", ChipSmokeRanks)
    hooks.HOOKS.register_module("ChipSmokeStop", ChipSmokeStop)
    with warnings_recorded() as caught:
        train_tool.main(argv)
    dump()


def rank_test(argv, out_dir, tag):
    """Phase 14b and 14c, one rank: the tester CLI (`tools/test.py`'s
    `main`) inside the group `launch` built; records, launches and the
    fragments this rank forwarded."""
    torch = _rank_setup()
    from cdsegnet_torch.engine.test import SemSegTester
    from cdsegnet_torch.ops import flash_attention as fa
    from cdsegnet_torch.parallel import dist
    from cdsegnet_torch.tools import test as test_tool
    from cdsegnet_torch.utils import cuda_build

    forwarded = []

    def counting(fn):
        def run(self, point, noise):
            forwarded.append(int(point.mask.sum().item()))
            return fn(self, point, noise)
        return run

    cuda_build.reset_launch_counts()
    with patched((SemSegTester, "forward_fragment", counting)), \
            warnings_recorded() as caught:
        tester = test_tool.main(argv)
    out = dict(records={n: {k: v.tolist() for k, v in r.items()}
                        for n, r in tester.records.items()},
               result=tester.result, launches=fa.patch_attention_fwd.launches,
               forwarded=forwarded, backend=torch.distributed.get_backend(),
               world=dist.world_size(), warnings=caught)
    with open(os.path.join(out_dir, f"{tag}_rank{dist.rank()}.json"), "w") as f:
        json.dump(out, f)


@contextlib.contextmanager
def warnings_recorded():
    """The distinct warning messages raised in the block (a determinism
    warning names an operation without a deterministic kernel), in the list
    it yields as they come."""
    import warnings

    caught = []

    def keep(message, *args, **kwargs):
        text = str(message)[:300]
        if text not in caught:
            caught.append(text)

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = keep
        yield caught


def phase_ranks(torch, config, cfg, tmp, ckpt, n_train_launches, n_launches, card):
    """Phase 14: the trainer and the tester on process groups, on this one
    card. (a) two gloo ranks (both on cuda:0) train the flagship config at
    full width with microbatch 2 through the training CLI, 2 epochs of 2
    steps on phase 9's rooms with two val rooms (one per rank); a second run
    stops after epoch 1 and a third resumes it: ranks bit-equal after every
    step, the resumed run bit-equal to the uninterrupted one, the summed
    val histograms equal to one process's evaluation of the same weights.
    (b) the tester CLI on two gloo ranks over phase 8's room (first
    augmentation), in SSI and in MSAI: records and preds equal to one
    process's, each rank forwarding its share. (c) the SSI tester call on a
    one-rank NCCL group."""
    from cdsegnet_torch.data.datasets import build_dataset
    from cdsegnet_torch.data.loader import EvalLoader
    from cdsegnet_torch.engine.checkpoint import CheckpointManager
    from cdsegnet_torch.engine.config import Config
    from cdsegnet_torch.engine.hooks import SemSegEvaluator
    from cdsegnet_torch.engine.state import make_eval_step
    from cdsegnet_torch.models.builder import build_model
    from cdsegnet_torch.ops import flash_attention as fa
    from cdsegnet_torch.parallel import dist
    from cdsegnet_torch.tools import test as test_tool
    from cdsegnet_torch.utils import cuda_build
    from cdsegnet_torch.utils.synthetic import room_scene

    start = time.perf_counter()
    torch.cuda.empty_cache()
    out_dir = os.path.join(tmp, "ranks_out")
    root = os.path.join(tmp, "ranks_data")
    for d in (os.path.join(root, "train"), os.path.join(root, "val"), out_dir):
        os.makedirs(d)
    for name in sorted(os.listdir(os.path.join(tmp, "data", "train"))):
        os.symlink(os.path.join(tmp, "data", "train", name),
                   os.path.join(root, "train", name))
    os.symlink(os.path.join(tmp, "data", "val", "scene0000_00.pth"),
               os.path.join(root, "val", "scene0000_00.pth"))
    torch.save(room_scene(VAL_ROOM_SEED), os.path.join(root, "val", "scene0001_00.pth"))

    # (a) training on two gloo ranks
    hook_cfg = [dict(type="CheckpointLoader"), dict(type="InformationWriter", log_interval=1),
                dict(type="SemSegEvaluator"), dict(type="CheckpointSaver", save_freq=1),
                dict(type="ChipSmokeRanks")]

    def train_argv(save, *extra):
        return ["--config-file", config, "--num-gpus", "2", "--device", "cuda:0",
                "--options", "epoch=2", "eval_epoch=2", "save_freq_threshold=1",
                "microbatch=2", "dist_backend=gloo", "data.train.loop=2",
                f"save_path={save}", f"hooks={hook_cfg!r}",
                f"data.train.data_root={root}", f"data.val.data_root={root}", *extra]

    runs = {}
    whole, resumed = os.path.join(tmp, "ranks_whole"), os.path.join(tmp, "ranks_resumed")
    stop_cfg = hook_cfg + [dict(type="ChipSmokeStop")]
    for name, save, extra in (("whole", whole, ()),
                              ("stopped", resumed, (f"hooks={stop_cfg!r}",)),
                              ("resumed", resumed, ("resume=True",))):
        run_dir = os.path.join(out_dir, name)
        os.makedirs(run_dir)
        t0 = time.perf_counter()
        stopped = False
        try:
            dist.launch(rank_train, 2, args=(train_argv(save, *extra), run_dir),
                        backend="gloo", device="cuda:0", timeout=600)
        except Exception as e:  # the deliberate stop, and nothing else
            stopped = name == "stopped" and "stopped after epoch 1" in str(e)
            if not stopped:
                raise
        if (name == "stopped") != stopped:
            fail(f"the {name} run {'did not stop' if name == 'stopped' else 'stopped'}")
        ranks = [json.load(open(os.path.join(run_dir, f"train_rank{r}.json")))
                 for r in (0, 1)]
        runs[name] = dict(wall_s=time.perf_counter() - t0, ranks=ranks,
                          files=sorted(os.listdir(os.path.join(save, "model"))))
        print(f"ranks train {name} " + json.dumps(dict(
            wall_s=runs[name]["wall_s"], files=runs[name]["files"],
            backend=[r["backend"] for r in ranks],
            peak_mem_gib=[r["peak_mem_gib"] for r in ranks],
            steps=[[dict(s, rank=i) for s in r["steps"]] for i, r in enumerate(ranks)],
            warnings=ranks[0]["warnings"])), flush=True)
    if runs["stopped"]["files"] != ["epoch_1", "model_best", "model_last"]:
        fail(f"checkpoints after the stopped run: {runs['stopped']['files']}")
    want = [2 * n_train_launches] * 4
    for name, n_steps in (("whole", 4), ("stopped", 2), ("resumed", 2)):
        for r in runs[name]["ranks"]:
            steps = r["steps"]
            if len(steps) != n_steps or r["backend"] != "gloo":
                fail(f"{name}: {len(steps)} steps on backend {r['backend']}")
            bad = [s for s in steps if s["launches"] != want or not s["equal"]
                   or s["max_abs_diff"] != 0 or not np.isfinite(s["loss"]) or any(s["dropped"])]
            if bad:
                fail(f"{name}: steps with launches other than {want}, ranks that differ, "
                     f"a non-finite loss or drops: {bad}")
    a = CheckpointManager(os.path.join(whole, "model")).restore_raw("model_last")
    b = CheckpointManager(os.path.join(resumed, "model")).restore_raw("model_last")
    same = dict(
        step=a["step"] == b["step"] == 4,
        model=all(torch.equal(v, b["model"][k]) for k, v in a["model"].items()),
        optimizer=a["optimizer"]["count"] == b["optimizer"]["count"] and all(
            torch.equal(v, b["optimizer"]["opt"]["state"][i][k])
            for i, st in a["optimizer"]["opt"]["state"].items() for k, v in st.items()),
        generators=len(a["rank_generators"]) == 2 and all(
            torch.equal(x[k], y[k]) for x, y in zip(a["rank_generators"], b["rank_generators"])
            for k in x))
    print(f"ranks resume {json.dumps(same)}", flush=True)
    if not all(same.values()):
        fail(f"the resumed two-rank run differs from the uninterrupted one: {same}")

    # the val histograms of the last epoch against one process's evaluation
    conf = Config.fromfile(config)
    model = build_model(cfg, device="cuda")
    model.load_state_dict(a["model"])
    del a, b
    stub = types.SimpleNamespace(
        cfg=conf, epoch=1, seed=conf.get("seed") or 0, model=model,
        device=torch.device("cuda"), logger=Log(), comm_info={}, storage=Storage(),
        eval_step=make_eval_step(model, conf.serialization_depth, 1, "cuda"),
        val_loader=EvalLoader(build_dataset(dict(conf.data.val, data_root=root)),
                              num_points=conf.get("val_num_points", 1 << 19)))
    evaluator = SemSegEvaluator()
    evaluator.trainer = stub
    deterministic(torch, True)
    try:
        evaluator.after_epoch()
    finally:
        deterministic(torch, False)
    got = [r["evals"][-1]["histograms"] for r in runs["whole"]["ranks"]]
    hist = dict(one_process=evaluator.histograms.tolist(), ranks=got,
                equal=all(g == evaluator.histograms.tolist() for g in got),
                labelled=int(evaluator.histograms[2].sum()))
    print(f"ranks eval {json.dumps(hist)}", flush=True)
    if not hist["equal"] or hist["labelled"] == 0:
        fail("the two ranks' summed val histograms are not one process's")
    del model, stub, evaluator
    torch.cuda.empty_cache()

    # (b), (c) the tester on phase 8's room, its first augmentation, in SSI
    # and in MSAI (each rank runs the DDIM loop of its own fragments)
    first_aug = [copy.deepcopy(conf.data.test.test_cfg.aug_transform[0])]
    modes = dict(ssi=((), n_launches),
                 msai=(("inference_mode=MSAI", f"inference_step={RANKS_MSAI_STEPS}"),
                       (RANKS_MSAI_STEPS + 1) * n_train_launches))

    def test_argv(save, mode):
        return ["--config-file", config, "--checkpoint", ckpt, "--device", "cuda:0",
                "--options", f"data.test.data_root={os.path.join(tmp, 'data')}",
                f"save_path={save}",
                f"data.test.test_cfg.aug_transform={json.loads(json.dumps(first_aug))!r}",
                *modes[mode][0]]

    ones = {}  # one process's run of each mode: records, result, launches
    for mode in modes:
        cuda_build.reset_launch_counts()
        deterministic(torch, True)
        try:
            one = test_tool.main(test_argv(os.path.join(tmp, f"ranks_one_{mode}"), mode))
        finally:
            deterministic(torch, False)
        ones[mode] = dict(records={n: {k: v.tolist() for k, v in rec.items()}
                                   for n, rec in one.records.items()},
                          result=one.result, launches=fa.patch_attention_fwd.launches)
        del one
        torch.cuda.empty_cache()
    one_launches = ones["ssi"]["launches"]
    n_frag = one_launches // n_launches
    if ones["msai"]["launches"] != n_frag * modes["msai"][1]:
        fail(f"one process's MSAI ran {ones['msai']['launches']} launches, expected "
             f"{n_frag} x {modes['msai'][1]}")
    tests = {}
    for tag, world, backend, mode in (("gloo2", 2, "gloo", "ssi"), ("nccl1", 1, "nccl", "ssi"),
                                      ("msai_gloo2", 2, "gloo", "msai")):
        t0 = time.perf_counter()
        dist.launch(rank_test, world,
                    args=(test_argv(os.path.join(tmp, f"ranks_{tag}"), mode), out_dir, tag),
                    backend=backend, device="cuda:0", timeout=300)
        ranks = [json.load(open(os.path.join(out_dir, f"{tag}_rank{r}.json")))
                 for r in range(world)]
        preds_equal = np.array_equal(
            np.load(os.path.join(tmp, f"ranks_{tag}", "result", "scene0000_00_pred.npy")),
            np.load(os.path.join(tmp, f"ranks_one_{mode}", "result", "scene0000_00_pred.npy")))
        tests[tag] = dict(
            wall_s=time.perf_counter() - t0, backend=[r["backend"] for r in ranks],
            launches=[r["launches"] for r in ranks],
            forwarded=[len(r["forwarded"]) for r in ranks],
            records_equal=all(r["records"] == ones[mode]["records"] for r in ranks),
            result_equal=all(r["result"] == ones[mode]["result"] for r in ranks),
            preds_equal=preds_equal, warnings=ranks[0]["warnings"])
        print(f"ranks test {tag} " + json.dumps(tests[tag]), flush=True)
        share = [len(range(r, n_frag, world)) for r in range(world)]
        t = tests[tag]
        if (t["backend"] != [backend] * world or t["forwarded"] != share
                or t["launches"] != [modes[mode][1] * k for k in share]
                or not (t["records_equal"] and t["result_equal"] and preds_equal)):
            fail(f"the {mode} tester on {world} {backend} rank(s) is not one process's "
                 f"({n_frag} fragments, shares {share}): {t}")
    result = dict(
        train={k: dict(wall_s=r["wall_s"],
                       step_ms=[[s["ms"] for s in rk["steps"]] for rk in r["ranks"]],
                       peak_mem_gib=[rk["peak_mem_gib"] for rk in r["ranks"]])
               for k, r in runs.items()},
        resume=same, eval=dict(equal=hist["equal"], labelled=hist["labelled"]),
        test=dict(fragments=n_frag, one_process_launches=one_launches,
                  one_process_msai_launches=ones["msai"]["launches"],
                  **{k: dict(wall_s=v["wall_s"], launches=v["launches"]) for k, v in tests.items()}),
        phase_s=time.perf_counter() - start, card=card)
    print("ranks " + json.dumps(result), flush=True)
    return result


# phase 15's option models at the full width of the ScanNet config: (a) FreeU
# (the JAX test's factors), bidirectional transfer with the b_channel_scale
# gate, dropout and the cond xCPE; (b) the Restomer, the lr_scale gate and the
# blocked xCPE; (c) RPE attention at patch 128 (the plain biased route)
PATCH_FIELDS = ("c_enc_patch_size", "c_dec_patch_size", "n_enc_patch_size",
                "n_dec_patch_size")
OPTION_MODELS = {
    "a": dict(b_factor=(1.2, 1.0, 1.0, 1.0), s_factor=(0.9, 1.0, 1.0, 1.0),
              tm_bidirectional=True, tm_feat="b_channel_scale", proj_drop=0.1,
              xcpe_mode="cond"),
    "b": dict(tm_restomer=True, tm_feat="lr_scale", xcpe_mode="blocked"),
    "c": dict(enable_rpe=True),
}
RPE_PATCH = 128
# phase 16's ablation segmentors: the ScanNet model with its type swapped,
# the diffused labels' branch given num_classes input channels (as the JAX
# package's tests set them), and the criteria of each family
ABLATIONS = ("ContinuousDMSegmentor", "CCDMSegmentor", "DiscreteDMSegmentor",
             "CDDMSegmentor", "DMSegmentor")
ABLATION_MSAI_STEPS = 5  # 6 DDIM forwards


def option_cfg(cfg, name):
    """The config's model with option model ``name``'s backbone fields."""
    c = copy.deepcopy(cfg)
    c["backbone"].update(OPTION_MODELS[name])
    if name == "c":
        for f in PATCH_FIELDS:
            c["backbone"][f] = (RPE_PATCH,) * len(c["backbone"][f])
    return c


def ablation_cfg(cfg, kind):
    """The config's model as ablation ``kind``: channels as the JAX
    package's tests set them (③⑤: the c-branch takes the labels; ④⑥: the
    n-branch; DM: one branch), and its criteria."""
    c = copy.deepcopy(cfg)
    bb = c["backbone"]
    k = c["num_classes"]
    mse = dict(type="MSELoss", loss_weight=1.0, ignore_index=-1)
    ce = dict(type="CrossEntropyLoss", loss_weight=1.0, ignore_index=-1)
    lovasz = dict(type="LovaszLoss", mode="multiclass", loss_weight=1.0, ignore_index=-1)
    kl = dict(type="D3PMKLLoss", loss_weight=1.0)
    if kind in ("ContinuousDMSegmentor", "DiscreteDMSegmentor"):
        bb["c_in_channels"] = k
        c["c_in_channels"] = k
    elif kind in ("CCDMSegmentor", "CDDMSegmentor"):
        bb["n_in_channels"] = k
    else:
        bb.update(condition=False, n_in_channels=k)
        c["condition"] = False
    crit = {"ContinuousDMSegmentor": ([mse, ce, lovasz], "GLS"),
            "CCDMSegmentor": ([mse, ce, lovasz], "GLS"),
            "DiscreteDMSegmentor": ([kl, ce, lovasz], "EW"),
            "CDDMSegmentor": ([mse, kl, ce, lovasz], "EW"),
            "DMSegmentor": ([kl, ce, lovasz], "EW")}[kind]
    c.update(type=kind, criteria=crit[0], loss_type=crit[1])
    return c


def set_xcpe_mode(model, mode):
    """The xCPE formulation of every block of ``model`` (one set of
    weights: the formulations share their parameters)."""
    model.backbone.xcpe_mode = mode
    for m in model.modules():
        if hasattr(m, "conv_mode"):
            m.conv_mode = mode


def route_counters(torch, plain_calls, biased_calls):
    """`patched` entries counting the plain attention route (the kernel
    wrapper's alternative) and the biased plain attention of RPE blocks."""
    from cdsegnet_torch.models import ptv3
    from cdsegnet_torch.ops import flash_attention as fa

    return ((fa, "patch_attention", counting_plain(plain_calls)),
            (ptv3, "patch_attention", counting_plain(biased_calls)))


def step_counts(fa, plain_calls, biased_calls):
    return dict(fwd=fa.patch_attention_fwd.launches,
                fwd_lse=fa.patch_attention_fwd.lse_launches,
                bwd_dq=fa.patch_attention_bwd_dq.launches,
                bwd_dkdv=fa.patch_attention_bwd_dkdv.launches,
                plain=plain_calls[0], biased=biased_calls[0])


def ssi_gap(torch, logits_k, logits_p, valid):
    """Kernel route against plain route on softmax probabilities
    (``TOL_TEST``'s measures)."""
    pk = torch.softmax(logits_k.float(), -1)[valid]
    pp = torch.softmax(logits_p.float(), -1)[valid]
    return dict(max_abs_dp=(pk - pp).abs().max().item(),
                argmax_agree=(pk.argmax(1) == pp.argmax(1)).float().mean().item())


def timed_ms(torch, fn, reps):
    """Synchronized host-clock ms of ``reps`` calls after one warm-up."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def phase_options(torch, conf, cfg, point, gap_point, train_point, card):
    """Phase 15: option models (a), (b), (c) of `OPTION_MODELS` at full
    width (random weights from seed 0), each in turn: one SSI on phase 4's
    scene (launches, plain and biased attention calls, finite logits, host
    ms), its route gap against the plain attention route on the 32,768-slot
    scene (``TOL_TEST``), and the training step of the config's optimizer on
    phase 6's bucket (the first step counted, then 3 warm-ups and the median
    of 5; peak memory). (a), (b): 32 kernel launches per SSI and 36 + 36 +
    36 per step, no plain attention; (c): no kernel launch, every
    self-attention through the biased plain route (32 per SSI, 36 per step
    forward). Then the xCPE formulations of the shipped model on phase 4's
    scene: SSI ms of "gather" and "blocked" ("cond" computes the gather);
    blocked against gather
    within ``TOL_TEST`` in bf16 and within 1e-5 of max |logits| with the
    whole model in f32."""
    from cdsegnet_torch.engine.optimizer import build_optimizer
    from cdsegnet_torch.engine.state import make_train_step
    from cdsegnet_torch.models.builder import build_model, build_model_criteria
    from cdsegnet_torch.ops import flash_attention as fa
    from cdsegnet_torch.utils import cuda_build

    plain_calls, biased_calls = [0], [0]
    results = {}
    gen = lambda seed: torch.Generator(device="cuda").manual_seed(seed)
    noise = torch.randn((point.num_points, 6), generator=gen(7), device="cuda")
    gnoise = torch.randn((gap_point.num_points, 6), generator=gen(8), device="cuda")
    for name in OPTION_MODELS:
        start = time.perf_counter()
        c = option_cfg(cfg, name)
        rpe = name == "c"
        n_ssi = len(attention_launches(c["backbone"]))
        n_step = len(attention_launches(c["backbone"], c_decoder=True))
        model = build_model(c, device="cuda", generator=torch.Generator().manual_seed(0))
        ssi = lambda pt, nz: model.inference(pt, noise=nz)["seg_logits"]
        cuda_build.reset_launch_counts()
        plain_calls[0] = biased_calls[0] = 0
        with patched(*route_counters(torch, plain_calls, biased_calls)):
            torch.cuda.reset_peak_memory_stats()
            logits = ssi(point, noise)
            torch.cuda.synchronize()
            ssi_counts = step_counts(fa, plain_calls, biased_calls)
            ssi_peak = torch.cuda.max_memory_allocated() / 2 ** 30
            ssi_times = timed_ms(torch, lambda: ssi(point, noise), 3)
        want_ssi = dict(fwd=0 if rpe else n_ssi, fwd_lse=0, bwd_dq=0, bwd_dkdv=0,
                        plain=0, biased=n_ssi if rpe else 0)
        finite = bool(torch.isfinite(logits[point.mask]).all().item())
        lk = ssi(gap_point, gnoise)
        set_attention_route(model, False)
        lp = ssi(gap_point, gnoise)
        set_attention_route(model, None)
        gap = dict(ssi_gap(torch, lk, lp, gap_point.mask), slots=gap_point.num_points)
        del lk, lp, logits

        model.train()
        opt = build_optimizer(dict(conf["optimizer"]), model, dict(conf["scheduler"]),
                              total_steps=TRAIN_TOTAL_STEPS,
                              param_dicts=[dict(p) for p in conf["param_dicts"]],
                              clip_keywords=conf.get("gredient_clip", []), device="cuda")
        step = make_train_step(model, build_model_criteria(c), opt, seed=0, device="cuda")
        cuda_build.reset_launch_counts()
        plain_calls[0] = biased_calls[0] = 0
        with patched(*route_counters(torch, plain_calls, biased_calls)):
            torch.cuda.reset_peak_memory_stats()
            metrics = step(train_point)
            torch.cuda.synchronize()
            counts = step_counts(fa, plain_calls, biased_calls)
            losses, times = [metrics["loss"].item()], []
            for i in range(8):  # 3 warm-ups, then 5 timed steps
                t0 = time.perf_counter()
                m = step(train_point)
                torch.cuda.synchronize()
                losses.append(m["loss"].item())
                if i >= 3:
                    times.append((time.perf_counter() - t0) * 1e3)
        k = 0 if rpe else n_step
        want_step = dict(fwd=k, fwd_lse=k, bwd_dq=k, bwd_dkdv=k, plain=0,
                         biased=n_step if rpe else 0)
        result = dict(options=OPTION_MODELS[name], patch=RPE_PATCH if rpe else 1024,
                      ssi_launches=ssi_counts, ssi_ms=statistics.median(ssi_times),
                      ssi_ms_all=ssi_times, ssi_peak_mem_gib=ssi_peak, route_gap=gap,
                      step_launches=counts, losses=losses,
                      dropped_per_level=[int(metrics[f"dropped_l{i}"]) for i in range(1, 5)],
                      step_ms=statistics.median(times), step_ms_all=times,
                      step_slots=train_point.num_points,
                      peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                      phase_s=time.perf_counter() - start, card=card)
        print(f"options {name} " + json.dumps(result), flush=True)
        if ssi_counts != want_ssi or not finite:
            fail(f"option model {name}: SSI counts {ssi_counts}, expected {want_ssi}, "
                 f"or non-finite logits")
        if gap["max_abs_dp"] > TOL_TEST[0] or gap["argmax_agree"] < TOL_TEST[1]:
            fail(f"option model {name}: SSI through the kernel disagrees with the "
                 f"plain route {gap}")
        if counts != want_step or not np.isfinite(losses).all():
            fail(f"option model {name}: step counts {counts}, expected {want_step}, "
                 f"or non-finite losses {losses}")
        results[name] = result
        del model, opt, step, metrics, m
        torch.cuda.empty_cache()

    # the xCPE formulations of the shipped model, one set of weights
    model = build_model(cfg, device="cuda", generator=torch.Generator().manual_seed(0))
    xcpe, logits = {}, {}
    for mode in ("gather", "blocked"):
        set_xcpe_mode(model, mode)
        logits[mode] = model.inference(point, noise=noise)["seg_logits"]
        xcpe[mode] = timed_ms(torch, lambda: model.inference(point, noise=noise), 5)
    bf16_gap = ssi_gap(torch, logits["blocked"], logits["gather"], point.mask)
    del model, logits
    f32 = copy.deepcopy(cfg)
    f32["backbone"].update(dtype="float32", upcast_softmax=True)
    model = build_model(f32, device="cuda", generator=torch.Generator().manual_seed(0))
    got = {}
    for mode in ("gather", "blocked"):
        set_xcpe_mode(model, mode)
        got[mode] = model.inference(point, noise=noise)["seg_logits"][point.mask]
    f32_gap = dict(max_abs_dlogits=(got["blocked"] - got["gather"]).abs().max().item(),
                   max_abs_logits=got["gather"].abs().max().item())
    del model, got
    torch.cuda.empty_cache()
    results["xcpe"] = dict(ssi_ms={m: statistics.median(t) for m, t in xcpe.items()},
                           ssi_ms_all=xcpe, blocked_vs_gather_bf16=bf16_gap,
                           blocked_vs_gather_f32=f32_gap, card=card)
    print("options xcpe " + json.dumps(results["xcpe"]), flush=True)
    if bf16_gap["max_abs_dp"] > TOL_TEST[0] or bf16_gap["argmax_agree"] < TOL_TEST[1]:
        fail(f"the blocked xCPE disagrees with the gather in bf16: {bf16_gap}")
    if f32_gap["max_abs_dlogits"] > 1e-5 * f32_gap["max_abs_logits"]:
        fail(f"the blocked xCPE disagrees with the gather in f32: {f32_gap}")
    return results


def phase_ablations(torch, config, conf, cfg, tmp, point, gap_point, train_point,
                    msai_point, n_raw, card):
    """Phase 16: the ablation segmentors of `ABLATIONS` at full width
    (random weights from seed 0), each in turn: one SSI on phase 4's scene
    (32 launches, DM 26; no plain attention), its route gap on the
    32,768-slot scene (``TOL_TEST``), one training step of the config's
    optimizer through `make_train_step` on phase 6's bucket (36 + 36 + 36
    launches, DM 26 + 26 + 26; finite loss; drops per level; a second step
    timed; peak memory), `inference_multistep` MSAI (``ABLATION_MSAI_STEPS``
    steps: 6 forwards of 36 launches, DM 26) and MSFI on phase 8's first
    fragment. Then ⑥ through the training CLI on phase 9's rooms (one
    evaluated epoch of 2 steps, checkpoints) and the tester CLI on phase 8's
    room with its first augmentation (the non-CNF route: every fragment 36
    launches, every raw point a prediction)."""
    from cdsegnet_torch.engine.optimizer import build_optimizer
    from cdsegnet_torch.engine.state import make_train_step
    from cdsegnet_torch.models.ablation_segmentors import inference_multistep
    from cdsegnet_torch.models.builder import build_model, build_model_criteria
    from cdsegnet_torch.ops import flash_attention as fa
    from cdsegnet_torch.utils import cuda_build

    plain_calls, biased_calls = [0], [0]
    results = {}
    for kind in ABLATIONS:
        start = time.perf_counter()
        c = ablation_cfg(cfg, kind)
        n_ssi = len(attention_launches(c["backbone"]))
        n_step = len(attention_launches(c["backbone"], c_decoder=True))
        model = build_model(c, device="cuda", generator=torch.Generator().manual_seed(0))

        def ssi(pt, seed):
            g = torch.Generator(device="cuda").manual_seed(seed)
            return model.inference(pt, generator=g)["seg_logits"]

        cuda_build.reset_launch_counts()
        plain_calls[0] = biased_calls[0] = 0
        with patched(*route_counters(torch, plain_calls, biased_calls)):
            logits = ssi(point, 7)
            torch.cuda.synchronize()
            ssi_counts = step_counts(fa, plain_calls, biased_calls)
            ssi_times = timed_ms(torch, lambda: ssi(point, 7), 3)
        finite = bool(torch.isfinite(logits[point.mask]).all().item())
        lk = ssi(gap_point, 8)
        set_attention_route(model, False)
        lp = ssi(gap_point, 8)
        set_attention_route(model, None)
        gap = dict(ssi_gap(torch, lk, lp, gap_point.mask), slots=gap_point.num_points)
        del lk, lp, logits

        model.train()
        opt = build_optimizer(dict(conf["optimizer"]), model, dict(conf["scheduler"]),
                              total_steps=TRAIN_TOTAL_STEPS,
                              param_dicts=[dict(p) for p in conf["param_dicts"]],
                              clip_keywords=conf.get("gredient_clip", []), device="cuda")
        step = make_train_step(model, build_model_criteria(c), opt, seed=0, device="cuda")
        cuda_build.reset_launch_counts()
        plain_calls[0] = biased_calls[0] = 0
        with patched(*route_counters(torch, plain_calls, biased_calls)):
            torch.cuda.reset_peak_memory_stats()
            metrics = step(train_point)
            torch.cuda.synchronize()
            counts = step_counts(fa, plain_calls, biased_calls)
            t0 = time.perf_counter()
            m2 = step(train_point)
            torch.cuda.synchronize()
            step_ms = (time.perf_counter() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated() / 2 ** 30

        model.eval()
        msai = {}
        for mode in ("avg", "final"):
            g = torch.Generator(device="cuda").manual_seed(9)
            cuda_build.reset_launch_counts()
            plain_calls[0] = 0
            with patched(*route_counters(torch, plain_calls, biased_calls)):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = inference_multistep(model, msai_point, step=ABLATION_MSAI_STEPS,
                                          mode=mode, generator=g)
                torch.cuda.synchronize()
            msai[mode] = dict(launches=fa.patch_attention_fwd.launches, plain=plain_calls[0],
                              ms=(time.perf_counter() - t0) * 1e3,
                              finite=bool(torch.isfinite(out[msai_point.mask]).all().item()))
        per = (ABLATION_MSAI_STEPS + 1) * n_step
        losses = [metrics["loss"].item(), m2["loss"].item()]
        want_ssi = dict(fwd=n_ssi, fwd_lse=0, bwd_dq=0, bwd_dkdv=0, plain=0, biased=0)
        want_step = dict(fwd=n_step, fwd_lse=n_step, bwd_dq=n_step, bwd_dkdv=n_step,
                         plain=0, biased=0)
        result = dict(ssi_launches=ssi_counts, ssi_ms=statistics.median(ssi_times),
                      ssi_ms_all=ssi_times, route_gap=gap, step_launches=counts,
                      losses=losses,
                      dropped_per_level=[int(metrics[f"dropped_l{i}"]) for i in range(1, 5)],
                      second_step_ms=step_ms, step_slots=train_point.num_points,
                      peak_mem_gib=peak, multistep=msai, multistep_per_fragment=per,
                      fragment_slots=msai_point.num_points,
                      phase_s=time.perf_counter() - start, card=card)
        print(f"ablation {kind} " + json.dumps(result), flush=True)
        if ssi_counts != want_ssi or not finite:
            fail(f"{kind}: SSI counts {ssi_counts}, expected {want_ssi}, or non-finite")
        if gap["max_abs_dp"] > TOL_TEST[0] or gap["argmax_agree"] < TOL_TEST[1]:
            fail(f"{kind}: SSI through the kernel disagrees with the plain route {gap}")
        if counts != want_step or not np.isfinite(losses).all():
            fail(f"{kind}: step counts {counts}, expected {want_step}, or non-finite "
                 f"losses {losses}")
        if any(r["launches"] != per or r["plain"] or not r["finite"] for r in msai.values()):
            fail(f"{kind}: multistep {msai}, expected {per} launches each")
        results[kind] = dict(result, n_ssi=n_ssi, n_step=n_step)
        del model, opt, step, metrics, m2, out
        torch.cuda.empty_cache()
    results["cli"] = ablation_clis(torch, config, conf, cfg, tmp, n_raw, card)
    return results


def ablation_clis(torch, config, conf, cfg, tmp, n_raw, card):
    """⑥ (`CDDMSegmentor`) through the training CLI on phase 9's rooms,
    one evaluated epoch of 2 steps, then the tester CLI on phase 8's room
    with its first augmentation from the run's ``model_last``."""
    from cdsegnet_torch.ops import flash_attention as fa
    from cdsegnet_torch.tools import test as test_tool
    from cdsegnet_torch.tools import train as train_tool
    from cdsegnet_torch.utils import cuda_build

    kind = "CDDMSegmentor"
    c = ablation_cfg(cfg, kind)
    n_step = len(attention_launches(c["backbone"], c_decoder=True))
    n_ssi = len(attention_launches(c["backbone"]))
    model_opts = [f"model.type={kind}",
                  f"model.backbone.n_in_channels={c['backbone']['n_in_channels']}",
                  f"model.criteria={c['criteria']!r}", f"model.loss_type={c['loss_type']}"]
    data_root = os.path.join(tmp, "data")
    save = os.path.join(tmp, "ablation_train")
    hook_cfg = [dict(type="CheckpointLoader"), dict(type="IterationTimer", warmup_iter=2),
                dict(type="InformationWriter", log_interval=1),
                dict(type="SemSegEvaluator"), dict(type="CheckpointSaver")]
    argv = ["--config-file", config, "--options", "epoch=1", "eval_epoch=1",
            f"save_path={save}", f"hooks={hook_cfg!r}",
            f"data.train.data_root={data_root}", f"data.val.data_root={data_root}",
            *model_opts]
    plain_calls, biased_calls = [0], [0]
    cuda_build.reset_launch_counts()
    t0 = time.perf_counter()
    with patched(*route_counters(torch, plain_calls, biased_calls)):
        trainer = train_tool.main(argv)
        torch.cuda.synchronize()
    train = dict(wall_s=time.perf_counter() - t0, steps=trainer.step,
                 launches=step_counts(fa, plain_calls, biased_calls),
                 files=sorted(os.listdir(os.path.join(save, "model"))),
                 miou=trainer.comm_info.get("current_metric_value"),
                 metrics=[json.loads(x) for x in
                          open(os.path.join(save, "metrics.jsonl")).read().splitlines()])
    print("ablation train cli " + json.dumps(train), flush=True)
    want = dict(fwd=2 * n_step + n_ssi, fwd_lse=2 * n_step, bwd_dq=2 * n_step,
                bwd_dkdv=2 * n_step, plain=0, biased=0)
    if train["steps"] != 2 or train["launches"] != want or \
            not {"model_best", "model_last"} <= set(train["files"]):
        fail(f"{kind} training CLI: {train['steps']} steps, launches "
             f"{train['launches']} (expected {want}), checkpoints {train['files']}")
    if not all(np.isfinite(r["loss"]) for r in train["metrics"] if "loss" in r) or \
            not 0.0 <= train["miou"] <= 1.0:
        fail(f"{kind} training CLI: non-finite losses or mIoU {train['miou']}")
    del trainer
    torch.cuda.empty_cache()

    conf_test = load_config("scannet/cdsegnet.py")
    first_aug = [copy.deepcopy(conf_test.data.test.test_cfg.aug_transform[0])]
    out = os.path.join(tmp, "ablation_test")
    argv = ["--config-file", config, "--checkpoint",
            os.path.join(save, "model", "model_last"), "--options",
            f"data.test.data_root={data_root}", f"save_path={out}",
            f"data.test.test_cfg.aug_transform={json.loads(json.dumps(first_aug))!r}",
            *model_opts]
    from cdsegnet_torch.engine.test import SemSegTester

    frags, plain = [], [0]
    cuda_build.reset_launch_counts()
    t0 = time.perf_counter()
    with patched((fa, "patch_attention", counting_plain(plain)),
                 (SemSegTester, "forward_fragment", recording_forward(torch, frags, plain))):
        tester = test_tool.main(argv)
    torch.cuda.synchronize()
    (pred_file,) = os.listdir(os.path.join(out, "result"))
    pred = np.load(os.path.join(out, "result", pred_file))
    test = dict(wall_s=time.perf_counter() - t0, fragments=len(frags),
                per_fragment=sorted({f["launches"] for f in frags}),
                plain=sum(f["plain"] for f in frags),
                ms_median=statistics.median(f["ms"] for f in frags),
                predicted=int(pred.size), raw_points=n_raw,
                classes_predicted=int(np.unique(pred).size), result=tester.result)
    print("ablation test cli " + json.dumps(test), flush=True)
    if not frags or test["per_fragment"] != [n_step] or test["plain"] or \
            not all(f["finite"] for f in frags):
        fail(f"{kind} tester: launches per fragment {test['per_fragment']} (expected "
             f"{n_step}), plain {test['plain']}, or non-finite logits")
    if pred.size != n_raw or pred.min() < 0 or pred.max() >= cfg["num_classes"]:
        fail(f"{kind} tester: {pred.size} predictions for {n_raw} raw points")
    return dict(train=train, test=test, card=card)


class Log:
    """A logger that keeps nothing (phase 14's one-process evaluation)."""

    def info(self, msg):
        pass

    warning = info


class Storage:
    def put_scalar(self, name, value):
        pass


PTV2_CONFIG = "scannet/ptv2.py"
# phase 17's other modes: m1 (grouped weights) and m3 with one PDNorm condition
PTV2_MODES = {"PT-v2m1": {}, "PT-v2m3": dict(num_conditions=1)}
SHAPE_CONFIGS = {  # phase 18: config, synthetic tree writer, shapes per split
    "modelnet40": ("modelnet40/cls_ptv2.py", "write_modelnet", dict(train=16, test=40)),
    "shapenetpart": ("shapenetpart/partseg_ptv2.py", "write_shapenet_part",
                     dict(train=16, val=16, test=16)),
}


def phase_ptv2(torch, point, train_point, card):
    """Phase 17: PTv2 (`configs/scannet/ptv2.py`, bf16, random weights from
    seed 0). One eval forward on phase 4's scene (3 warm-ups, median of
    10, geometry included); the training step of the config (CE + Lovasz,
    AdamW + OneCycle) on phase 6's 204,800-slot bucket (3 warm-ups, median
    of 5; peak memory), then one recorded step: the kernel's launches on
    `knn_fused.launches`, set to 0 before it, must equal the `knn` calls
    its spans show, one table a level, and the profiler gives the kernel's
    device ms beside its bound (the step's pairs at `KNN_PAIR_INSTRUCTIONS`
    each, at the card's FP32 issue rate of 67 TFLOP/s / 2); at every level
    of that bucket `knn`, which runs the fused kernel (`csrc/knn.cu`),
    against its dense plain version: indices equal, distances equal to the
    bit, one launch a call; timed per level: `knn` (events), the kernel
    alone (the profiler's device time), its bound and the dense version;
    m1 and m3 (one condition): one eval forward each.
    Everything finite; no metric level may drop a point; PTv2 runs no
    attention kernel."""
    from cdsegnet_torch.engine.state import make_train_step
    from cdsegnet_torch.models.builder import build_model
    from cdsegnet_torch.ops import flash_attention as fa
    from cdsegnet_torch.ops.pointops import knn, knn_dense, knn_fused
    from cdsegnet_torch.utils import cuda_build, tracing
    from torch.profiler import ProfilerActivity, profile

    start = time.perf_counter()
    conf = load_config(PTV2_CONFIG)
    cfg = copy.deepcopy(dict(conf.model))
    cuda_build.reset_launch_counts()
    model = build_model(cfg, device="cuda", generator=torch.Generator().manual_seed(0))
    levels, _ = model.backbone.precompute_geometry(point)
    eval_levels = dict(sizes=[lv.size for lv in levels],
                       valid=[int(lv.point.mask.sum().item()) for lv in levels],
                       dropped=[lv.dropped for lv in levels[1:]])
    del levels
    fwd = torch.no_grad()(lambda m=model: m(point)["n_pred"])
    logits = fwd()
    eval_finite = bool(torch.isfinite(logits[point.mask]).all().item())
    if tuple(logits.shape) != (point.num_points, 20) or not eval_finite:
        fail(f"PTv2 eval logits {tuple(logits.shape)}, finite {eval_finite}")
    fwd()
    eval_ms = timed_ms(torch, fwd, 10)  # its own warm-up: the third
    del model, logits
    torch.cuda.empty_cache()

    model, criteria, opt = train_setup(torch, conf, cfg)
    step = make_train_step(model, criteria, opt, seed=0, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    metrics = step(train_point)
    torch.cuda.synchronize()
    losses = [metrics["loss"].item()]
    drops = [int(metrics[f"dropped_l{i}"]) for i in range(1, 5)]
    named = dict(model.named_parameters())
    bad = [n for n, p in named.items() if p.grad is None or not torch.isfinite(p.grad).all()]
    times = []
    for i in range(8):  # 3 warm-ups, then 5 timed steps
        t0 = time.perf_counter()
        m = step(train_point)
        torch.cuda.synchronize()
        losses.append(m["loss"].item())
        if i >= 3:
            times.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    # one recorded step: the kernel's own counter against the `knn` spans
    knn_fused.launches = 0
    with tracing.capture() as cap, profile(activities=[ProfilerActivity.CUDA]) as prof:
        step(train_point)
        torch.cuda.synchronize()
    step_knn = dict(launches=knn_fused.launches,
                    calls=sum(s.name == "pointops.knn" for s in cap.spans),
                    pairs=cap.counters["knn.pairs"], kernel_ms=profiled_ms(prof, "knn_fused"))
    step_knn["bound_ms"] = knn_bound_ms(step_knn["pairs"])
    print("ptv2 knn step " + json.dumps(step_knn), flush=True)
    del cap, prof
    if not np.isfinite(losses).all() or bad:
        fail(f"PTv2 training: losses {losses}, parameters without a finite gradient "
             f"{bad[:5]}")
    del step, opt, metrics, m
    torch.cuda.empty_cache()

    # the compacted kNN against its dense plain version at every level of
    # the training bucket
    model.eval()
    bb = model.backbone
    levels, _ = bb.precompute_geometry(train_point)
    knn_rows = []
    for lv in levels:
        p = lv.point
        args = (p.coord, p.coord, bb.k_neighbors, p.mask, p.mask)
        ids = dict(query_batch=p.batch, ref_batch=p.batch)
        with tracing.capture() as cap:
            ci, cd = knn(*args, **ids)
        di, dd = knn_dense(*args, **ids)
        torch.cuda.synchronize()
        rel = ((cd - dd).abs() / dd.abs().clamp(min=1e-30)).max().item()
        row = dict(slots=p.num_points, valid=int(p.mask.sum().item()),
                   indices_equal=bool(torch.equal(ci, di)),
                   dists_equal=bool(torch.equal(cd, dd)), max_rel_dist=rel,
                   launches=cap.launches["knn"], pairs=cap.counters["knn.pairs"],
                   host_syncs=cap.counters.get(tracing.SYNCS, 0),
                   ms=cuda_ms(torch, lambda: knn(*args, **ids), warmup=1, iters=3),
                   kernel_ms=device_ms(torch, lambda: knn(*args, **ids), "knn_fused", 3),
                   dense_ms=cuda_ms(torch, lambda: knn_dense(*args, **ids), warmup=0,
                                    iters=1))
        row["bound_ms"] = knn_bound_ms(row["pairs"])
        knn_rows.append(row)
        print(f"ptv2 knn level {len(knn_rows) - 1} " + json.dumps(row), flush=True)
        del ci, cd, di, dd
        torch.cuda.empty_cache()
    train_levels = dict(sizes=[lv.size for lv in levels],
                        valid=[int(lv.point.mask.sum().item()) for lv in levels],
                        dropped=[lv.dropped for lv in levels[1:]])
    del model, levels
    torch.cuda.empty_cache()

    modes = {}
    for kind, extra in PTV2_MODES.items():
        c = copy.deepcopy(cfg)
        c["backbone"].update(type=kind, **extra)
        m = build_model(c, device="cuda", generator=torch.Generator().manual_seed(0))
        with torch.no_grad():
            t0 = time.perf_counter()
            out = m(point)["n_pred"]
            torch.cuda.synchronize()
        modes[kind] = dict(ms=(time.perf_counter() - t0) * 1e3,
                           finite=bool(torch.isfinite(out[point.mask]).all().item()))
        del m, out
        torch.cuda.empty_cache()
    launches = dict(fwd=fa.patch_attention_fwd.launches,
                    bwd_dq=fa.patch_attention_bwd_dq.launches)

    step_ms = statistics.median(times)
    result = dict(
        eval_ms=statistics.median(eval_ms), eval_ms_all=eval_ms, eval_slots=point.num_points,
        eval_levels=eval_levels, step_ms=step_ms, step_ms_all=times, losses=losses,
        dropped_per_level=drops, step_slots=train_point.num_points,
        step_valid=int(train_point.mask.sum().item()),
        points_per_s=int(train_point.mask.sum().item()) / (step_ms / 1e3),
        peak_mem_gib=peak, train_levels=train_levels,
        knn_ms_per_level=[r["ms"] for r in knn_rows],
        knn_kernel_ms_per_level=[r["kernel_ms"] for r in knn_rows],
        knn_bound_ms_per_level=[r["bound_ms"] for r in knn_rows],
        knn_dense_ms_per_level=[r["dense_ms"] for r in knn_rows],
        knn_step=step_knn,
        knn_share_of_step=sum(r["ms"] for r in knn_rows) / step_ms,
        modes=modes, attention_launches=launches,
        phase_s=time.perf_counter() - start, card=card)
    print("ptv2 " + json.dumps(result), flush=True)
    if any(not (r["indices_equal"] and r["dists_equal"]) for r in knn_rows):
        fail(f"the kNN kernel differs from its dense plain version: {knn_rows}")
    if any(r["launches"] != 1 for r in knn_rows):
        fail(f"a kNN call did not launch the kernel once: {knn_rows}")
    if not step_knn["launches"] == step_knn["calls"] == len(knn_rows):
        fail(f"the recorded step launched the kNN kernel {step_knn['launches']} times for "
             f"{step_knn['calls']} `knn` calls and {len(knn_rows)} levels")
    if any(eval_levels["dropped"]) or any(train_levels["dropped"]) or any(drops):
        fail(f"PTv2's metric levels dropped points: eval {eval_levels['dropped']}, "
             f"train {train_levels['dropped']}, step {drops}")
    if not all(r["finite"] for r in modes.values()):
        fail(f"PTv2 modes: non-finite logits {modes}")
    if any(launches.values()):
        fail(f"PTv2 launched the attention kernels {launches}")
    return result


def knn_bound_ms(pairs: int) -> float:
    """The fused kNN's bound for ``pairs`` distances: FP32 issue."""
    return pairs * KNN_PAIR_INSTRUCTIONS / (PEAK_FLOPS["float32"] / 2) * 1e3


def knn_entry(ptv2):
    """The kernels line's entry of the fused kNN: phase 17's recorded PTv2
    training step (the wrapper's counter, the kernel's device ms, its
    bound). It replaces no TPU kernel: the JAX package's kNN is XLA's
    distances and `lax.top_k`."""
    s = ptv2["knn_step"]
    return dict(name="knn_fused_kernel", route="cuda", source="cdsegnet_torch/csrc/knn.cu",
                replaces=None, paths=dict(ptv2=dict(launches=s["launches"], ms=s["kernel_ms"],
                                                    bound_ms=s["bound_ms"])))


def phase_shapes(torch, tmp, card):
    """Phase 18: the shape tasks through the CLIs at the full width of
    `configs/modelnet40/cls_ptv2.py` and `configs/shapenetpart/
    partseg_ptv2.py` (random weights from the config's seed), on synthetic
    trees in the datasets' formats at their published point counts (40
    ModelNet classes, the 16 ShapeNetPart categories). `tools/train.py`: 2
    epochs of 2 steps (8 shapes each), each step logged, each epoch evaluated
    (`ClsEvaluator`, `SemSegEvaluator`, shapes padded into the 524,288-slot
    val bucket) and checkpointed; then `tools/test.py` (`ClsTester`,
    `PartSegTester`) on ``model_last``. Gates: finite losses, allAcc, mAcc,
    mIoU and both part mIoUs in [0, 1], one prediction per shape or a vote
    for every point, the checkpoints."""
    from cdsegnet_torch.data.datasets import build_dataset
    from cdsegnet_torch.tools import test as test_tool
    from cdsegnet_torch.tools import train as train_tool
    from cdsegnet_torch.utils import synthetic

    results = {}
    for name, (config, writer, shapes) in SHAPE_CONFIGS.items():
        base = os.path.join(tmp, "shapes")
        root, save = os.path.join(base, name), os.path.join(base, f"{name}_run")
        t0 = time.perf_counter()
        getattr(synthetic, writer)(root, shapes, seed=0)
        write_s = time.perf_counter() - t0
        evaluator = "ClsEvaluator" if name == "modelnet40" else "SemSegEvaluator"
        hooks = [dict(type="CheckpointLoader"), dict(type="IterationTimer", warmup_iter=2),
                 dict(type="InformationWriter", log_interval=1), dict(type=evaluator),
                 dict(type="CheckpointSaver", save_freq=1)]
        cfg_file = os.path.join(base, f"{name}.py")
        with open(cfg_file, "w") as f:
            f.write(f"_base_ = [{config_path(config)!r}]\nepoch = 2\neval_epoch = 2\n"
                    f"hooks = {hooks!r}\ndata = dict(train=dict(data_root={root!r}), "
                    f"val=dict(data_root={root!r}), test=dict(data_root={root!r}))\n")
        t0 = time.perf_counter()
        trainer = train_tool.main(["--config-file", cfg_file, "--options",
                                   f"save_path={save}"])
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        with open(os.path.join(save, "metrics.jsonl")) as f:
            recs = [json.loads(line) for line in f]
        losses = [r["loss"] for r in recs]
        ckpts = sorted(os.listdir(os.path.join(save, "model")))
        metric = (trainer.comm_info["current_metric_name"],
                  trainer.comm_info["current_metric_value"])
        steps_per_epoch = trainer.steps_per_epoch
        del trainer
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        tester = test_tool.main(["--config-file", cfg_file, "--checkpoint", "model_last",
                                 "--options", f"save_path={save}"])
        torch.cuda.synchronize()
        test_s = time.perf_counter() - t0
        ds = build_dataset(dict(tester.cfg.data.test))
        n_points = {ds.get_data_name(i): ds.get_data(i)["segment"].size
                    for i in range(len(ds))}
        if name == "modelnet40":
            covered = len(tester.records) == len(ds) == shapes["test"]
        else:
            covered = (sorted(tester.records) == sorted(n_points) and all(
                rec["pred"].size == rec["voted"] == n_points[k]
                for k, rec in tester.records.items()))
        result = dict(write_s=write_s, train_s=train_s, test_s=test_s, shapes=shapes,
                      steps=len(recs), steps_per_epoch=steps_per_epoch, losses=losses,
                      val_metric=metric, checkpoints=ckpts, test_result=tester.result,
                      test_shapes=len(tester.records), covered=covered,
                      points_per_shape=[min(n_points.values()), max(n_points.values())],
                      card=card)
        print(f"shapes {name} " + json.dumps(result), flush=True)
        in_unit = lambda x: 0.0 <= x <= 1.0
        if len(recs) != 4 or not np.isfinite(losses).all():
            fail(f"{name}: {len(recs)} logged steps, losses {losses}")
        if ckpts != ["epoch_1", "epoch_2", "model_best", "model_last"]:
            fail(f"{name}: checkpoints {ckpts}")
        if not in_unit(metric[1]) or not all(map(in_unit, tester.result.values())):
            fail(f"{name}: val {metric}, test {tester.result}")
        if not covered:
            fail(f"{name}: not one prediction per shape or per point")
        results[name] = result
        del tester
        torch.cuda.empty_cache()
    return results


SPARSE_CONFIGS = dict(spunet="scannet/spunet.py", oacnns="scannet/oacnns.py",
                      cac="scannet/cac_spunet.py", pointgroup="scannet/insseg_pointgroup.py",
                      spvcnn="semantic_kitti/spvcnn.py")
SPARSE_GAP_POINTS = 16384  # phase 19's card-against-CPU scene
# f32 logits on the card against the CPU, of max |logits| (TF32 off on both)
TOL_SPARSE_CARD = 1e-4
INSSEG_ROOM_SEEDS = (1, 2)  # phase 19's PointGroup train rooms (with instance ids)
KITTI_SWEEP_SEEDS = dict(train=(1, 2), val=(3,))  # sequences 00 and 08


def level_summary(levels):
    return dict(sizes=[lv.size for lv in levels],
                valid=[int(lv.point.mask.sum().item()) for lv in levels],
                dropped=[int(lv.dropped) for lv in levels[1:]])


def sparse_forward(torch, name, cfg, point, reps=10, tag="sparse", warmups=3,
                   allow_drops=False, **call):
    """One eval forward of ``cfg``'s model (random weights from seed 0;
    with ``call``, e.g. a PDNorm ``condition``, of its backbone):
    ``warmups`` forwards (the first checked, on the geometry built for the
    level summary), then the median of ``reps``
    synchronized host-clock forwards, geometry included; the pyramid's
    levels and drops (a drop fails unless ``allow_drops``); peak memory."""
    from cdsegnet_torch.models.builder import build_model

    model = build_model(copy.deepcopy(cfg), device="cuda",
                        generator=torch.Generator().manual_seed(0))
    geometry = model.backbone.precompute_geometry(point)
    levels = level_summary(geometry[0])
    fwd = torch.no_grad()(lambda g=None: model.backbone(point, geometry=g, **call) if call
                          else model(point, geometry=g)["n_pred"])
    torch.cuda.reset_peak_memory_stats()
    logits = fwd(geometry)  # the first warm-up takes the summary's geometry
    del geometry
    finite = bool(torch.isfinite(logits[point.mask]).all().item())
    shape = tuple(logits.shape)
    del logits
    times = []
    if reps:
        for _ in range(warmups - 1):
            fwd()
        torch.cuda.synchronize()
        for _ in range(reps):
            t0 = time.perf_counter()
            fwd()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    del model
    torch.cuda.empty_cache()
    out = dict(ms=statistics.median(times) if times else None, ms_all=times,
               levels=levels, finite=finite, shape=shape, peak_mem_gib=peak)
    print(f"{tag} {name} eval " + json.dumps(out), flush=True)
    if not finite or shape[0] != point.num_points or (
            any(levels["dropped"]) and not allow_drops):
        fail(f"{name} eval forward: logits {shape}, finite {finite}, drops "
             f"{levels['dropped']}")
    return out


def sparse_step(torch, name, conf, point, check_terms=False, tag="sparse", warmups=3,
                reps=5, clip=True, allow_drops=False):
    """The config's training step (its optimizer and schedule, and its
    ``gredient_clip`` when ``clip``; random weights from seed 0) through
    `make_train_step`: the first step checked (finite loss and gradients,
    no drop unless ``allow_drops``), then ``warmups`` more and the median of
    ``reps`` timed steps; peak memory. ``check_terms``: every criteria
    term of one more training forward finite (CAC's four)."""
    from cdsegnet_torch.engine.optimizer import build_optimizer
    from cdsegnet_torch.engine.state import make_train_step
    from cdsegnet_torch.models.builder import build_model, build_model_criteria

    cfg = copy.deepcopy(dict(conf.model))
    model = build_model(cfg, device="cuda", generator=torch.Generator().manual_seed(0))
    criteria = build_model_criteria(cfg)
    opt = build_optimizer(dict(conf.optimizer), model, dict(conf.scheduler),
                          total_steps=TRAIN_TOTAL_STEPS,
                          param_dicts=[dict(p) for p in conf.get("param_dicts", [])],
                          clip_keywords=conf.get("gredient_clip", []) if clip else [],
                          device="cuda")
    step = make_train_step(model, criteria, opt, seed=0, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    metrics = step(point)
    torch.cuda.synchronize()
    losses = [metrics["loss"].item()]
    drops = [int(metrics[k]) for k in sorted(metrics) if k.startswith("dropped_l")]
    bad = [n for n, p in model.named_parameters()
           if p.grad is None or not torch.isfinite(p.grad).all()]
    times = []
    for i in range(warmups + reps):  # the warm-ups, then the timed steps
        t0 = time.perf_counter()
        m = step(point)
        torch.cuda.synchronize()
        losses.append(m["loss"].item())
        if i >= warmups:
            times.append((time.perf_counter() - t0) * 1e3)
    terms = None
    if check_terms:
        with torch.no_grad():
            out = model(point, generators=step.generators)
            terms = [float(t) for t in criteria._terms(out)]
        del out
    n_valid = int(point.mask.sum().item())
    step_ms = statistics.median(times)
    result = dict(step_ms=step_ms, step_ms_all=times, losses=losses, dropped_per_level=drops,
                  slots=point.num_points, valid=n_valid,
                  points_per_s=n_valid / (step_ms / 1e3),
                  peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                  optimizer=opt.kind, lrs=opt.lrs(), terms=terms)
    print(f"{tag} {name} step " + json.dumps(result), flush=True)
    del step, opt, model, metrics, m
    torch.cuda.empty_cache()
    if not np.isfinite(losses).all() or bad or (any(drops) and not allow_drops):
        fail(f"{name} training step: losses {losses}, parameters without a finite "
             f"gradient {bad[:5]}, drops {drops}")
    if check_terms and (len(terms) != len(cfg["criteria"]) or not np.isfinite(terms).all()):
        fail(f"{name}: criteria terms {terms} for {len(cfg['criteria'])} losses")
    return result


def sparse_card_gap(torch, name, cfg, tag="sparse"):
    """f32 logits of ``cfg``'s model on a 16,384-slot scene, the card
    against the CPU (same weights, same arrays; TF32 off): max |difference|
    over the valid slots, over max |logits|."""
    from cdsegnet_torch.models.builder import build_model
    from cdsegnet_torch.utils.synthetic import synthetic_point_batch

    c = copy.deepcopy(cfg)
    c["backbone"]["dtype"] = "float32"
    model = build_model(c, device="cpu", generator=torch.Generator().manual_seed(0))
    got = {}
    for dev in ("cpu", "cuda"):
        point = synthetic_point_batch(SPARSE_GAP_POINTS, 1, depth=10, seed=1, device=dev)
        with torch.no_grad():
            got[dev] = model.to(dev)(point)["n_pred"].cpu()
        valid = point.mask.cpu()
    ref = got["cpu"][valid]
    gap = ((got["cuda"][valid] - ref).abs().max() / ref.abs().max()).item()
    out = dict(slots=SPARSE_GAP_POINTS, valid=int(valid.sum()), rel_gap=gap,
               tol=TOL_SPARSE_CARD)
    print(f"{tag} {name} card against cpu " + json.dumps(out), flush=True)
    del model
    torch.cuda.empty_cache()
    if not gap <= TOL_SPARSE_CARD:
        fail(f"{name}: f32 logits on the card differ from the CPU's by {gap} of max "
             f"|logits| (tolerance {TOL_SPARSE_CARD})")
    return out


def sparse_cli(torch, name, tmp, data):
    """``tools/train.py`` on a config that `_base_`s ``SPARSE_CONFIGS[name]``
    with ``data`` (the data roots, and transforms) and one evaluated epoch
    of two passes: finite losses, the checkpoints."""
    from cdsegnet_torch.tools import train as train_tool

    base = os.path.join(tmp, "sparse")
    save = os.path.join(base, f"{name}_run")
    hooks = [dict(h, log_interval=1) if h["type"] == "InformationWriter" else h
             for h in load_config(SPARSE_CONFIGS[name]).hooks]
    cfg_file = os.path.join(base, f"{name}.py")
    with open(cfg_file, "w") as f:
        f.write(f"_base_ = [{config_path(SPARSE_CONFIGS[name])!r}]\nepoch = 2\n"
                f"eval_epoch = 1\nhooks = {hooks!r}\ndata = {data!r}\n")
    t0 = time.perf_counter()
    trainer = train_tool.main(["--config-file", cfg_file, "--options", f"save_path={save}"])
    torch.cuda.synchronize()
    with open(os.path.join(save, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    result = dict(train_s=time.perf_counter() - t0, steps=trainer.step,
                  losses=[r["loss"] for r in recs],
                  checkpoints=sorted(os.listdir(os.path.join(save, "model"))),
                  metric=[trainer.comm_info.get("current_metric_name"),
                          trainer.comm_info.get("current_metric_value")])
    if not np.isfinite(result["losses"]).all() or result["steps"] != 2 or \
            not {"model_best", "model_last"} <= set(result["checkpoints"]):
        fail(f"{name} training CLI: {result}")
    return trainer, cfg_file, save, result


def phase_sparse(torch, point, train_point, tmp, card):
    """Phase 19: the sparse-conv family at the full width of its shipped
    configs (random weights from a seed): SpUNet-v1m1 (f32; eval forward on
    phase 4's scene, the SGD-Nesterov + OneCycle step on phase 6's bucket),
    MinkUNet and SpUNet-v1m3 (three conditions, condition 1) one forward
    each, OACNNs (bf16; forward and AdamW step), CAC (its SGD step, its four
    loss terms finite), PointGroup through the training CLI on synthetic
    rooms with instance ids (one evaluated epoch of 2 steps, InsSegEvaluator:
    mAP, AP50 and AP25 finite and in [0, 1]), SPVCNN (bf16) through the
    training CLI on synthetic SemanticKITTI sweeps and the tester CLI with
    its submission files, and its step on phase 6's bucket; then SpUNet's
    and OACNNs' f32 logits on the card against the CPU on a 16,384-slot
    scene. No attention kernel may launch; no pooled level may drop a
    point."""
    from cdsegnet_torch.data.datasets import build_dataset
    from cdsegnet_torch.ops import flash_attention as fa
    from cdsegnet_torch.tools import test as test_tool
    from cdsegnet_torch.utils import cuda_build
    from cdsegnet_torch.utils.synthetic import (lidar_sweep, room_scene,
                                                write_semantic_kitti)

    start = time.perf_counter()
    cuda_build.reset_launch_counts()
    confs = {k: load_config(v) for k, v in SPARSE_CONFIGS.items()}
    res = dict(card=card)
    spunet_cfg = dict(confs["spunet"].model)
    res["spunet_eval"] = sparse_forward(torch, "spunet", spunet_cfg, point)
    res["spunet_step"] = sparse_step(torch, "spunet", confs["spunet"], train_point)
    for kind, extra, call in (("MinkUNet", {}, {}),
                              ("SpUNet-v1m3", dict(num_conditions=3), dict(condition=1))):
        c = copy.deepcopy(spunet_cfg)
        c["backbone"].update(type=kind, **extra)
        res[kind] = sparse_forward(torch, kind, c, point, reps=0, **call)
    res["oacnns_eval"] = sparse_forward(torch, "oacnns", dict(confs["oacnns"].model), point)
    res["oacnns_step"] = sparse_step(torch, "oacnns", confs["oacnns"], train_point)
    res["cac_step"] = sparse_step(torch, "cac", confs["cac"], train_point, check_terms=True)

    # PointGroup through the training CLI: rooms with instance ids; the
    # shipped GridSample keeps no instance ids (its keys omit them, in the
    # JAX config too), so the run's pipelines add "instance" to them
    t0 = time.perf_counter()
    root = os.path.join(tmp, "sparse", "insseg")
    for split, seeds in (("train", INSSEG_ROOM_SEEDS), ("val", (ROOM_SEED,))):
        os.makedirs(os.path.join(root, split))
        for i, seed in enumerate(seeds):
            torch.save(room_scene(seed, instances=True),
                       os.path.join(root, split, f"scene{i:04d}_00.pth"))
    write_s = time.perf_counter() - t0
    pipeline = copy.deepcopy(list(confs["pointgroup"].data.train.transform))
    for t in pipeline:
        if t["type"] == "GridSample":
            t["keys"] = ("coord", "color", "normal", "segment", "instance")
    pg_data = dict(train=dict(data_root=root, transform=pipeline),
                   val=dict(data_root=root, transform=pipeline))
    trainer, _, _, pg = sparse_cli(torch, "pointgroup", tmp, pg_data)
    ev = next(h for h in trainer.hooks if type(h).__name__ == "InsSegEvaluator")
    pg.update(write_s=write_s, summary={k: v for k, v in ev.summary.items()
                                        if k != "per_class_ap"},
              gt_instances=sum(len(g) for r in ev.records for g in r["gt"].values()),
              proposals=sum(len(p) for r in ev.records for p in r["pred"].values()))
    print("sparse pointgroup cli " + json.dumps(pg), flush=True)
    if not all(0.0 <= pg["summary"][k] <= 1.0 for k in ("all_ap", "all_ap_50", "all_ap_25")):
        fail(f"PointGroup: mAP/AP50/AP25 {pg['summary']}")
    res["pointgroup_cli"] = pg
    del trainer, ev
    torch.cuda.empty_cache()

    # SPVCNN through the training and testing CLIs on synthetic sweeps
    t0 = time.perf_counter()
    kitti = os.path.join(tmp, "sparse", "kitti")
    write_semantic_kitti(kitti, {"00": [lidar_sweep(s) for s in KITTI_SWEEP_SEEDS["train"]],
                                 "08": [lidar_sweep(s) for s in KITTI_SWEEP_SEEDS["val"]]})
    kitti_data = dict(train=dict(data_root=kitti), val=dict(data_root=kitti),
                      test=dict(data_root=kitti))
    trainer, cfg_file, save, sp = sparse_cli(torch, "spvcnn", tmp, kitti_data)
    sp["write_s"] = time.perf_counter() - t0 - sp["train_s"]
    del trainer
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    tester = test_tool.main(["--config-file", cfg_file, "--checkpoint", "model_last",
                             "--options", f"save_path={save}", "submission=True"])
    torch.cuda.synchronize()
    ds = build_dataset(dict(tester.cfg.data.test))
    labels = {}
    for i in range(len(ds)):
        seq, frame = ds.get_data_name(i).split("_")
        f = os.path.join(save, "submit", "sequences", seq, "predictions", f"{frame}.label")
        raw = np.fromfile(f, dtype=np.uint32) if os.path.exists(f) else None
        labels[ds.get_data_name(i)] = dict(
            points=int(ds.get_data(i)["coord"].shape[0]),
            labels=None if raw is None else int(raw.size),
            raw_ids_known=raw is not None and bool(np.isin(
                raw, list(ds.learning_map_inv.values())).all()))
    sp.update(test_s=time.perf_counter() - t0, test_result=tester.result,
              submission=labels)
    print("sparse spvcnn cli " + json.dumps(sp), flush=True)
    if not all(v["labels"] == v["points"] and v["raw_ids_known"] for v in labels.values()):
        fail(f"SPVCNN submission files: {labels}")
    if not all(0.0 <= v <= 1.0 for v in tester.result.values()):
        fail(f"SPVCNN tester result {tester.result}")
    res["spvcnn_cli"] = sp
    del tester
    torch.cuda.empty_cache()
    # the bucket's first 4 feature channels stand in for (x, y, z, remission)
    res["spvcnn_step"] = sparse_step(torch, "spvcnn", confs["spvcnn"], train_point.replace(
        feat=train_point.feat[:, :confs["spvcnn"].model.backbone.in_channels]))

    res["card_gap"] = {n: sparse_card_gap(torch, n, dict(confs[n].model))
                       for n in ("spunet", "oacnns")}
    res["attention_launches"] = dict(fwd=fa.patch_attention_fwd.launches,
                                     fwd_lse=fa.patch_attention_fwd.lse_launches,
                                     bwd_dq=fa.patch_attention_bwd_dq.launches,
                                     bwd_dkdv=fa.patch_attention_bwd_dkdv.launches)
    res["phase_s"] = time.perf_counter() - start
    summary = {k: v for k, v in res.items() if k not in ("pointgroup_cli", "spvcnn_cli")}
    print("sparse " + json.dumps(summary), flush=True)
    if any(res["attention_launches"].values()):
        fail(f"the sparse-conv family launched the attention kernels "
             f"{res['attention_launches']}")
    return res


ZOO_CONFIGS = dict(ptv1="scannet/ptv1.py", octformer="scannet/octformer.py",
                   stratified="scannet/stratified.py", swin3d="scannet/swin3d.py")
FPS_CHECK_POINTS = 16384  # phase 20's card-against-CPU FPS scene


def recorded_fps(torch, calls):
    """A ``make`` for `patched`: each FPS call's picks appended to
    ``calls``; on the card between two CUDA events (``(picks, start,
    end)``) and under ``set_sync_debug_mode("error")``, so that a host read
    inside FPS raises."""
    def make(fps):
        def run(*args, **kwargs):
            if not args[0].is_cuda:
                calls.append((fps(*args, **kwargs), None, None))
                return calls[-1][0]
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            torch.cuda.set_sync_debug_mode("error")
            try:
                out = fps(*args, **kwargs)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            end.record()
            calls.append((out, start, end))
            return out
        return run
    return make


def fps_ms(torch, calls, levels):
    """ms per level of the last forward's ``levels`` FPS calls."""
    torch.cuda.synchronize()
    return [a.elapsed_time(b) for _, a, b in calls[-levels:]]


def phase_zoo(torch, point, train_point, tmp, n_raw, card):
    """Phase 20: PTv1 and the window-attention family; see the module
    docstring."""
    from cdsegnet_torch.ops import flash_attention as fa
    from cdsegnet_torch.models.builder import build_model
    from cdsegnet_torch.tools import test as test_tool
    from cdsegnet_torch.tools import train as train_tool
    from cdsegnet_torch.utils import cuda_build
    from cdsegnet_torch.utils.synthetic import synthetic_point_batch

    start = time.perf_counter()
    cuda_build.reset_launch_counts()
    confs = {k: load_config(v) for k, v in ZOO_CONFIGS.items()}
    res = dict(card=card)

    # PTv1: the eval forward and the step (1 warm-up and 1 timed each: FPS
    # takes seconds), FPS per level inside them and its share
    from cdsegnet_torch.models import ptv1 as ptv1_mod

    ptv1_cfg = dict(confs["ptv1"].model)
    n_fps = len(ptv1_cfg["backbone"]["channels"]) - 1
    calls = []
    with patched((ptv1_mod, "farthest_point_sampling_batched", recorded_fps(torch, calls))):
        res["ptv1_eval"] = sparse_forward(torch, "ptv1", ptv1_cfg, point, reps=1, tag="zoo",
                                          warmups=1)
        fps = dict(eval=dict(ms_per_level=fps_ms(torch, calls, n_fps)))
        res["ptv1_step"] = sparse_step(torch, "ptv1", confs["ptv1"], train_point, tag="zoo",
                                       warmups=0, reps=1)
        fps["train"] = dict(ms_per_level=fps_ms(torch, calls, n_fps))
    if len(calls) != 4 * n_fps:
        fail(f"PTv1 ran FPS {len(calls)} times in 2 forwards and 2 steps")
    for which, ms in (("eval", res["ptv1_eval"]["ms"]), ("train", res["ptv1_step"]["step_ms"])):
        fps[which].update(ms=sum(fps[which]["ms_per_level"]),
                          share=sum(fps[which]["ms_per_level"]) / ms)
    # the four levels' picks on a small scene, the card against the CPU
    bb = build_model(copy.deepcopy(ptv1_cfg), device="cpu").backbone
    got = {}
    for dev in ("cpu", "cuda"):
        calls = []
        with patched((ptv1_mod, "farthest_point_sampling_batched",
                      recorded_fps(torch, calls))):
            bb.precompute_geometry(synthetic_point_batch(FPS_CHECK_POINTS, 1, depth=10,
                                                         seed=1, device=dev))
        got[dev] = [c[0].cpu() for c in calls]
    first = None
    for lv, (a, b) in enumerate(zip(got["cpu"], got["cuda"])):
        diff = torch.nonzero(a != b).flatten()
        if diff.numel() and first is None:
            t = int(diff[0])
            first = dict(level=lv + 1, pick=t, cpu=int(a[t]), card=int(b[t]))
    fps["card_against_cpu"] = dict(slots=FPS_CHECK_POINTS, picks=[len(x) for x in got["cpu"]],
                                   first_difference=first)
    print("zoo ptv1 fps " + json.dumps(fps), flush=True)
    res["ptv1_fps"] = fps
    del bb, got
    if first is not None:
        fail(f"PTv1's FPS picks differ between the card and the CPU: {first}")

    # the window-attention family: eval forward, step, the card against the CPU
    for name in ("octformer", "stratified", "swin3d"):
        res[f"{name}_eval"] = sparse_forward(torch, name, dict(confs[name].model), point,
                                             tag="zoo", allow_drops=True)
        res[f"{name}_step"] = sparse_step(torch, name, confs[name], train_point, tag="zoo",
                                          clip=False, allow_drops=True)
    res["card_gap"] = {n: sparse_card_gap(torch, n, dict(confs[n].model), tag="zoo")
                       for n in ("octformer", "stratified", "swin3d")}

    # OctFormer through the training CLI (phase 9's rooms, phase 8's room as
    # val) and the tester CLI (phase 8's room, its first augmentation)
    config = config_path(ZOO_CONFIGS["octformer"])
    data_root = os.path.join(tmp, "data")
    save = os.path.join(tmp, "zoo_octformer")
    hook_cfg = [dict(type="CheckpointLoader"), dict(type="IterationTimer", warmup_iter=2),
                dict(type="InformationWriter", log_interval=1),
                dict(type="SemSegEvaluator"), dict(type="CheckpointSaver")]
    t0 = time.perf_counter()
    trainer = train_tool.main(["--config-file", config, "--options", "epoch=1",
                               "eval_epoch=1", f"save_path={save}", f"hooks={hook_cfg!r}",
                               f"data.train.data_root={data_root}",
                               f"data.val.data_root={data_root}"])
    torch.cuda.synchronize()
    recs = [json.loads(x) for x in open(os.path.join(save, "metrics.jsonl")).read().splitlines()]
    cli = dict(train_s=time.perf_counter() - t0, steps=trainer.step,
               losses=[r["loss"] for r in recs if "loss" in r],
               checkpoints=sorted(os.listdir(os.path.join(save, "model"))),
               miou=trainer.comm_info.get("current_metric_value"))
    del trainer
    torch.cuda.empty_cache()
    first_aug = [copy.deepcopy(load_config("scannet/cdsegnet.py").data.test.test_cfg
                               .aug_transform[0])]
    out = os.path.join(tmp, "zoo_octformer_test")
    t0 = time.perf_counter()
    tester = test_tool.main([
        "--config-file", config, "--checkpoint", os.path.join(save, "model", "model_last"),
        "--options", f"data.test.data_root={data_root}", f"save_path={out}",
        f"data.test.test_cfg.aug_transform={json.loads(json.dumps(first_aug))!r}"])
    torch.cuda.synchronize()
    (pred_file,) = os.listdir(os.path.join(out, "result"))
    pred = np.load(os.path.join(out, "result", pred_file))
    cli.update(test_s=time.perf_counter() - t0, predicted=int(pred.size), raw_points=n_raw,
               classes_predicted=int(np.unique(pred).size), test_result=tester.result)
    print("zoo octformer cli " + json.dumps(cli), flush=True)
    del tester
    torch.cuda.empty_cache()
    res["octformer_cli"] = cli
    if cli["steps"] != 2 or not np.isfinite(cli["losses"]).all() or not cli["losses"] or \
            not {"model_best", "model_last"} <= set(cli["checkpoints"]) or \
            not 0.0 <= cli["miou"] <= 1.0:
        fail(f"OctFormer training CLI: {cli}")
    if pred.size != n_raw or pred.min() < 0 or pred.max() >= 20:
        fail(f"OctFormer tester: {pred.size} predictions for {n_raw} raw points")

    res["attention_launches"] = dict(fwd=fa.patch_attention_fwd.launches,
                                     fwd_lse=fa.patch_attention_fwd.lse_launches,
                                     bwd_dq=fa.patch_attention_bwd_dq.launches,
                                     bwd_dkdv=fa.patch_attention_bwd_dkdv.launches)
    res["phase_s"] = time.perf_counter() - start
    summary = {k: v for k, v in res.items() if k != "octformer_cli"}
    print("zoo " + json.dumps(summary), flush=True)
    if any(res["attention_launches"].values()):
        fail(f"the zoo launched the attention kernels {res['attention_launches']}")
    return res


MSC_CONFIG = "scannet/pretrain_msc.py"
PPT_CONFIG = "multidataset/ppt_spunet.py"
MSC_CHECK_POINTS = 16384  # phase 21's card-against-CPU view pair
TOL_MSC_CARD = 1e-4
PPT_ROOM_SEEDS = dict(structured3d=(11, 12, 13, 14), s3dis=(15, 16))


def msc_pair(torch, n, device, seed=1):
    """A synthetic view pair of one scene: the scene at ``n`` slots, and a
    second view of its points in another order with jittered features;
    origins the points' own coordinates, targets their features."""
    from cdsegnet_torch.utils.synthetic import synthetic_point_batch

    v1 = synthetic_point_batch(n, 1, depth=10, seed=seed, device="cpu")
    gen = torch.Generator().manual_seed(seed)
    perm = torch.randperm(n, generator=gen)
    perm = torch.cat([perm[v1.mask[perm]], perm[~v1.mask[perm]]])  # valid rows first
    v2 = v1.replace(coord=v1.coord[perm], grid_coord=v1.grid_coord[perm],
                    feat=v1.feat[perm] + 0.01 * torch.randn(v1.feat.shape, generator=gen),
                    batch=v1.batch[perm], mask=v1.mask[perm])
    out = {}
    for name, v in (("view1", v1), ("view2", v2)):
        v = v.replace(**{k: getattr(v, k).to(device) for k in
                         ("coord", "grid_coord", "feat", "batch", "mask")})
        out[name] = v
        out[f"{name}_origin_coord"] = v.coord
        out[f"{name}_target"] = dict(color=v.feat[:, :3], normal=v.feat[:, 3:])
    return out


def phase_msc(torch, tmp, card):
    """Phase 21a: MSC pretraining at the shipped config's width; see the
    module docstring."""
    from cdsegnet_torch.data.datasets import build_dataset
    from cdsegnet_torch.data.loader import TrainLoader
    from cdsegnet_torch.engine.optimizer import build_optimizer
    from cdsegnet_torch.engine.state import make_msc_train_step, msc_inputs
    from cdsegnet_torch.models.builder import build_model, build_model_criteria
    from cdsegnet_torch.tools import train as train_tool

    from cdsegnet_torch.ops import flash_attention as fa
    from cdsegnet_torch.utils import cuda_build

    cuda_build.reset_launch_counts()
    conf = load_config(MSC_CONFIG)
    cfg = copy.deepcopy(dict(conf.model))
    keys = tuple(conf.pair_feat_keys)
    res = dict(card=card)
    # the shipped pipeline's first bucket of phase 9's rooms: 2 scenes, 2
    # views of 102,400 slots each
    t0 = time.perf_counter()
    ds = build_dataset(dict(conf.data.train, data_root=os.path.join(tmp, "data")))
    loader = TrainLoader(ds, scenes_per_device=conf.scenes_per_device,
                         num_points=conf.bucket_num_points, seed=conf.seed, prefetch=0,
                         pair_feat_keys=keys)
    inputs = msc_inputs(next(loader.epoch(0)), conf.serialization_depth,
                        conf.scenes_per_device, "cuda", keys)
    res["batch_s"] = time.perf_counter() - t0
    res["valid"] = [int(inputs[v].mask.sum().item()) for v in ("view1", "view2")]
    model = build_model(cfg, device="cuda", generator=torch.Generator().manual_seed(0))
    model.train()
    gen = torch.Generator("cuda").manual_seed(3)
    score = torch.rand(inputs["view1"].num_points, generator=gen, device="cuda")
    match = lambda: model.match_pairs(inputs["view1"], inputs["view2"],
                                      inputs["view1_origin_coord"],
                                      inputs["view2_origin_coord"], score)
    pairs, pair_valid = match()
    res["match_ms"] = cuda_ms(torch, match, warmup=0, iters=2)
    res["valid_pairs"] = int(pair_valid.sum().item())
    opt = build_optimizer(dict(conf.optimizer), model, dict(conf.scheduler),
                          total_steps=TRAIN_TOTAL_STEPS, device="cuda")
    step = make_msc_train_step(model, build_model_criteria(cfg), opt, seed=0, device="cuda")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    times, metrics = [], []
    for i in range(4):  # 1 warm-up, then 3 timed steps
        t0 = time.perf_counter()
        m = step(inputs)
        torch.cuda.synchronize()
        metrics.append({k: float(v) for k, v in m.items()})
        if i:
            times.append((time.perf_counter() - t0) * 1e3)
    res.update(step_ms=statistics.median(times), step_ms_all=times, metrics=metrics,
               match_share=res["match_ms"] / statistics.median(times),
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               lrs=opt.lrs())
    print("msc step " + json.dumps(res), flush=True)
    if res["valid_pairs"] == 0 or not all(np.isfinite(list(m.values())).all()
                                          for m in metrics):
        fail(f"MSC step: {res['valid_pairs']} valid pairs, metrics {metrics}")
    del step, opt, model, inputs, pairs, pair_valid, score
    torch.cuda.empty_cache()

    # the f32 loss on the card against the CPU's, the same draws injected
    model = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0)).train()
    draws = dict(seed=torch.tensor(12345), score=torch.rand(
        MSC_CHECK_POINTS, generator=torch.Generator().manual_seed(4)))
    losses = {}
    for dev in ("cpu", "cuda"):
        with torch.no_grad():
            out = model.to(dev)(**msc_pair(torch, MSC_CHECK_POINTS, dev),
                                **{k: v.to(dev) for k, v in draws.items()})
        losses[dev] = {k: float(out[k]) for k in ("loss", "nce_loss", "color_loss",
                                                  "normal_loss")}
    gap = abs(losses["cuda"]["loss"] - losses["cpu"]["loss"]) / abs(losses["cpu"]["loss"])
    res["card_gap"] = dict(slots=MSC_CHECK_POINTS, losses=losses, rel_gap=gap,
                           tol=TOL_MSC_CARD)
    print("msc card against cpu " + json.dumps(res["card_gap"]), flush=True)
    del model
    torch.cuda.empty_cache()
    if not gap <= TOL_MSC_CARD:
        fail(f"MSC: the f32 loss on the card differs from the CPU's by {gap}")

    # MSCTrainer through the training CLI: phase 9's four rooms, 2 steps
    save = os.path.join(tmp, "msc_run")
    hooks = [dict(h, log_interval=1) if h["type"] == "InformationWriter" else h
             for h in conf.hooks]
    t0 = time.perf_counter()
    trainer = train_tool.main(["--config-file", config_path(MSC_CONFIG), "--options",
                               "epoch=1", f"save_path={save}", f"hooks={hooks!r}",
                               f"data.train.data_root={os.path.join(tmp, 'data')}"])
    torch.cuda.synchronize()
    with open(os.path.join(save, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    cli = dict(train_s=time.perf_counter() - t0, steps=trainer.step,
               trainer=type(trainer).__name__,
               losses=[r["loss"] for r in recs if "loss" in r],
               nce=[r.get("nce_loss") for r in recs if "loss" in r],
               checkpoints=sorted(os.listdir(os.path.join(save, "model"))))
    print("msc cli " + json.dumps(cli), flush=True)
    del trainer
    torch.cuda.empty_cache()
    res["cli"] = cli
    if cli["steps"] != 2 or cli["trainer"] != "MSCTrainer" or \
            not np.isfinite(cli["losses"]).all() or "model_last" not in cli["checkpoints"]:
        fail(f"MSC training CLI: {cli}")
    res["attention_launches"] = fa.patch_attention_fwd.launches
    if res["attention_launches"]:
        fail(f"MSC launched the attention kernel {res['attention_launches']} times")
    return res


def ppt_trees(tmp):
    """Synthetic Structured3D and S3DIS trees beside phase 9's ScanNet
    rooms: 4 + 2 rooms."""
    from cdsegnet_torch.utils.synthetic import room_scene, write_s3dis, write_structured3d

    roots = dict(structured3d=os.path.join(tmp, "ppt", "structured3d"),
                 s3dis=os.path.join(tmp, "ppt", "s3dis"), scannet=os.path.join(tmp, "data"))
    write_structured3d(roots["structured3d"], {"train": [
        room_scene(s) for s in PPT_ROOM_SEEDS["structured3d"]]})
    write_s3dis(roots["s3dis"], {f"Area_{i + 1}": [room_scene(s)]
                                 for i, s in enumerate(PPT_ROOM_SEEDS["s3dis"])})
    return roots


def phase_ppt(torch, point, train_point, tmp, card):
    """Phase 21b-c: PPT through the training CLI and inline, and the
    dual-branch PPT over the flagship PTv3; see the module docstring.
    Returns the results and the dual-branch model's counted launches."""
    from cdsegnet_torch.engine import train as train_mod
    from cdsegnet_torch.engine.optimizer import build_optimizer
    from cdsegnet_torch.engine.state import make_train_step
    from cdsegnet_torch.models.builder import build_model, build_model_criteria
    from cdsegnet_torch.ops import flash_attention as fa
    from cdsegnet_torch.tools import train as train_tool
    from cdsegnet_torch.utils import cuda_build

    cuda_build.reset_launch_counts()
    conf = load_config(PPT_CONFIG)
    res = dict(card=card)
    # MultiDatasetTrainer through the CLI: Structured3D (ratio 2), ScanNet,
    # S3DIS; 4 Structured3D rooms make one epoch of [0, 0, 1, 2]
    t0 = time.perf_counter()
    roots = ppt_trees(tmp)
    write_s = time.perf_counter() - t0
    datasets = [dict(d) for d in conf.data.train.datasets]
    for d, key in zip(datasets, ("structured3d", "scannet", "s3dis")):
        d["data_root"] = roots[key]
    save = os.path.join(tmp, "ppt_run")
    hooks = [dict(h, log_interval=1) if h["type"] == "InformationWriter" else h
             for h in conf.hooks]
    cfg_file = os.path.join(tmp, "ppt", "ppt.py")
    with open(cfg_file, "w") as f:
        f.write(f"_base_ = [{config_path(PPT_CONFIG)!r}]\nepoch = 1\nhooks = {hooks!r}\n"
                f"data = dict(train=dict(datasets={datasets!r}))\n")
    steps = []

    def timed(fn):
        def select(self, ds_idx):
            inner = fn(self, ds_idx)

            def run(points):
                torch.cuda.synchronize()
                t = time.perf_counter()
                out = inner(points)
                torch.cuda.synchronize()
                steps.append(dict(dataset=ds_idx, condition=self.condition_of(ds_idx),
                                  ms=(time.perf_counter() - t) * 1e3,
                                  loss=float(out["loss"])))
                return out
            return run
        return select

    t0 = time.perf_counter()
    with patched((train_mod.MultiDatasetTrainer, "_select_train_step", timed)):
        trainer = train_tool.main(["--config-file", cfg_file, "--options",
                                   f"save_path={save}"])
    torch.cuda.synchronize()
    cli = dict(write_s=write_s, train_s=time.perf_counter() - t0, steps=trainer.step,
               dataset_idx=[s["dataset"] for s in steps], per_step=steps,
               conditions_trained=sorted(trainer.cond_steps),
               checkpoints=sorted(os.listdir(os.path.join(save, "model"))))
    print("ppt cli " + json.dumps(cli), flush=True)
    del trainer
    torch.cuda.empty_cache()
    res["cli"] = cli
    if cli["conditions_trained"] != [0, 1, 2] or cli["dataset_idx"] != [0, 0, 1, 2] or \
            not np.isfinite([s["loss"] for s in steps]).all():
        fail(f"PPT training CLI: {cli}")

    # the shipped PPT-v1m1's eval forward, and PPT-v1m2 built from it
    v1m1 = copy.deepcopy(dict(conf.model))
    res["v1m1_eval"] = sparse_forward(torch, "ppt_v1m1", v1m1, point, tag="ppt")
    v1m2 = {k: v for k, v in v1m1.items() if k not in ("class_embedding_path",
                                                       "clip_embed_dim")}
    v1m2.update(type="PPT-v1m2", num_classes=(25, 20, 13))
    res["v1m2_eval"] = sparse_forward(torch, "ppt_v1m2", v1m2, point, tag="ppt", reps=0)
    conf2 = copy.deepcopy(conf)
    conf2.model = v1m2
    res["v1m2_step"] = sparse_step(torch, "ppt_v1m2", conf2, train_point, tag="ppt",
                                   warmups=0, reps=1)
    res["spunet_attention_launches"] = fa.patch_attention_fwd.launches
    if res["spunet_attention_launches"]:
        fail(f"PPT over SpUNet launched the attention kernel "
             f"{res['spunet_attention_launches']} times")

    # the dual-branch PPT-v1m1 over the flagship PTv3 with dm: eval forward
    # on the bench scene, training step on the 204,800-slot bucket
    cnf = load_config("scannet/cdsegnet.py")
    dual_cfg = dict(type="PPT-v1m1", backbone=copy.deepcopy(dict(cnf.model.backbone)),
                    backbone_out_channels=96, context_channels=256,
                    conditions=v1m1["conditions"], condition=True,
                    criteria=copy.deepcopy(list(cnf.model.criteria)),
                    loss_type=cnf.model.loss_type, task_num=cnf.model.task_num,
                    **{k: cnf.model[k] for k in ("dm", "T", "beta_start", "beta_end",
                                                  "noise_schedule", "T_dim", "dm_input",
                                                  "dm_target", "dm_min_snr",
                                                  "c_in_channels") if k in cnf.model})
    model = build_model(dual_cfg, device="cuda", generator=torch.Generator().manual_seed(0))
    n_params = sum(p.numel() for p in model.parameters())
    bb = dual_cfg["backbone"]
    n_launches = len(attention_launches(bb, c_decoder=True))
    cuda_build.reset_launch_counts()
    gen = torch.Generator("cuda").manual_seed(7)
    with torch.no_grad():
        out = model(point, condition=1, generators=dict(diffusion=gen))
    torch.cuda.synchronize()
    eval_launches = fa.patch_attention_fwd.launches
    logits = out["n_pred"]
    finite = bool(torch.isfinite(logits[point.mask]).all().item())
    fwd = torch.no_grad()(lambda: model(point, condition=1, generators=dict(diffusion=gen)))
    eval_ms = cuda_ms(torch, fwd, warmup=2, iters=5)
    dual = dict(params=n_params, eval_launches=eval_launches, eval_ms=eval_ms,
                eval_shape=list(logits.shape), finite=finite)
    del out, logits
    model.train()
    opt = build_optimizer(dict(cnf.optimizer), model, dict(cnf.scheduler),
                          total_steps=TRAIN_TOTAL_STEPS,
                          param_dicts=[dict(p) for p in cnf.get("param_dicts", [])],
                          device="cuda")
    step = make_train_step(model, build_model_criteria(dual_cfg), opt, seed=0,
                           device="cuda", model_kwargs=dict(condition=1))
    torch.cuda.reset_peak_memory_stats()
    cuda_build.reset_launch_counts()
    m = step(train_point)
    torch.cuda.synchronize()
    counts = dict(fwd=fa.patch_attention_fwd.launches,
                  fwd_lse=fa.patch_attention_fwd.lse_launches,
                  bwd_dq=fa.patch_attention_bwd_dq.launches,
                  bwd_dkdv=fa.patch_attention_bwd_dkdv.launches)
    losses = [float(m["loss"])]
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        m = step(train_point)
        torch.cuda.synchronize()
        losses.append(float(m["loss"]))
        times.append((time.perf_counter() - t0) * 1e3)
    dual.update(step_launches=counts, step_ms=statistics.median(times), step_ms_all=times,
                losses=losses, peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                expected_launches=n_launches)
    print("ppt dual " + json.dumps(dual), flush=True)
    del step, opt, model, m
    torch.cuda.empty_cache()
    res["dual"] = dual
    if eval_launches != n_launches or any(c != n_launches for c in counts.values()):
        fail(f"the dual-branch PPT launched the kernels {eval_launches} times in its eval "
             f"forward and {counts} in a step, expected {n_launches} each")
    if not finite or not np.isfinite(losses).all():
        fail(f"the dual-branch PPT: finite logits {finite}, losses {losses}")
    return res


CROP = dict(type="SphereCrop", point_max=80000, mode="all")  # JAX's default point_max
CROP_AUGS = 2  # phase 22's crop tester: the first 2 of the 13 augmentations
PROFILE = dict(type="RuntimeProfiler", wait=1, active=2)
PROFILED_KERNELS = ("patch_attention_fwd_mma_kernel", "patch_attention_bwd_dq_mma_kernel",
                    "patch_attention_bwd_dkdv_mma_kernel")
REMAP_GRID = 0.2  # phase 22's coarse prediction: one raw point per 20 cm voxel


def crop_options(tmp):
    """The tester's ``--options`` of phase 22: phase 8's room through the
    shipped test pipeline with covering crops, its first augmentations."""
    augs = load_config("scannet/cdsegnet.py").data.test.test_cfg.aug_transform[:CROP_AUGS]
    return [f"data.test.data_root={os.path.join(tmp, 'data')}",
            f"data.test.test_cfg.crop={CROP!r}",
            f"data.test.test_cfg.aug_transform={json.loads(json.dumps(augs))!r}"]


def crop_scene(config, tmp):
    """Phase 22's test item, made by the host pipeline on the CPU with the
    tester's seed: grid fragments per augmentation and crops per grid
    fragment."""
    from cdsegnet_torch.data.datasets import build_dataset
    from cdsegnet_torch.engine.config import Config, parse_options

    cfg = Config.fromfile(config)
    cfg.merge_from_dict(parse_options(crop_options(tmp)))
    ds = build_dataset(dict(cfg.data.test))
    grid, crops = [], []
    voxelize, crop = ds.test_voxelize, ds.test_crop
    ds.test_voxelize = lambda data, rng: grid.append(voxelize(data, rng)) or grid[-1]
    ds.test_crop = lambda part, rng: crops.append(crop(part, rng)) or crops[-1]
    t0 = time.perf_counter()
    scene = ds.get(0, np.random.default_rng(cfg.seed))
    host_s = time.perf_counter() - t0
    per_frag = [len(c) for c in crops]
    sizes = [len(f["coord"]) for f in scene["fragment_list"]]
    print(f"crop scene: {len(grid)} augmentations (of 13, a cut in length only) x grid "
          f"fragments {[len(g) for g in grid]}; every grid fragment of "
          f"{min(len(p['coord']) for g in grid for p in g)}-"
          f"{max(len(p['coord']) for g in grid for p in g)} points split into "
          f"{per_frag} crops of {min(sizes)}-{max(sizes)} points (point_max "
          f"{CROP['point_max']}): {len(sizes)} fragments; host pipeline {host_s:.2f} s",
          flush=True)
    if min(per_frag) < 2 or len(sizes) != sum(per_frag):
        fail("a grid fragment of the crop scene did not split into crops")
    return scene


def phase_host(torch, config, cfg, tmp, ckpt, n_raw, scene, n_launches, n_train_launches,
               card):
    """The covering-crop tester, the visualizer on its prediction, and the
    trainer with the decode cache and `RuntimeProfiler`; see the module
    docstring (phase 22)."""
    from cdsegnet_torch.data import datasets
    from cdsegnet_torch.data.cache import cache_path
    from cdsegnet_torch.data.collate import pick_bucket
    from cdsegnet_torch.data.loader import TrainLoader
    from cdsegnet_torch.engine import train as train_mod
    from cdsegnet_torch.engine.config import Config, parse_options
    from cdsegnet_torch.engine.profiling import summarize_trace
    from cdsegnet_torch.engine.test import DEFAULT_BUCKETS, SemSegTester
    from cdsegnet_torch.models.builder import build_model
    from cdsegnet_torch.ops import flash_attention as fa
    from cdsegnet_torch.tools import test as test_tool
    from cdsegnet_torch.tools import train as train_tool
    from cdsegnet_torch.tools import visualize
    from cdsegnet_torch.utils import cuda_build
    from cdsegnet_torch.utils.visualization import read_ply, remap_to_origin, save_segmentation

    start = time.perf_counter()
    # ---- the covering-crop tester through its CLI ----
    save = os.path.join(tmp, "crop")
    argv = ["--config-file", config, "--checkpoint", ckpt, "--options",
            f"save_path={save}"] + crop_options(tmp)
    frags, plain_calls = [], [0]
    covered = np.zeros(n_raw, bool)

    def mark(fn):
        def run(self, frag, index, *args, **kwargs):
            covered[frag["index"]] = True
            return fn(self, frag, index, *args, **kwargs)
        return run

    cuda_build.reset_launch_counts()
    t0 = time.perf_counter()
    with patched((fa, "patch_attention", counting_plain(plain_calls)),
                 (SemSegTester, "predict_fragment", mark),
                 (SemSegTester, "forward_fragment",
                  recording_forward(torch, frags, plain_calls))):
        tester = test_tool.main(argv)
    torch.cuda.synchronize()
    scene_s = time.perf_counter() - t0
    launches = fa.patch_attention_fwd.launches
    n_frag = len(scene["fragment_list"])
    forward_s = sum(f["ms"] for f in frags) / 1e3
    pred = np.load(os.path.join(save, "result", "scene0000_00_pred.npy"))
    crop = dict(fragments=len(frags), host_pipeline_fragments=n_frag, launches=launches,
                per_fragment=sorted({f["launches"] for f in frags}),
                plain=sum(f["plain"] for f in frags), covered=int(covered.sum()),
                raw_points=n_raw, buckets=sorted({f["bucket"] for f in frags}),
                points=[min(f["points"] for f in frags), max(f["points"] for f in frags)],
                scene_s=scene_s, forward_s=forward_s, other_s=scene_s - forward_s,
                ssi_ms_median=statistics.median(f["ms"] for f in frags),
                result=tester.result)
    print("host crop tester " + json.dumps(crop), flush=True)
    if len(frags) != n_frag or launches != n_launches * n_frag:
        fail(f"the crop tester ran {len(frags)} fragments and {launches} launches, expected "
             f"{n_frag} (the host pipeline's) and {n_launches * n_frag}")
    if crop["per_fragment"] != [n_launches] or crop["plain"] or \
            not all(f["finite"] for f in frags):
        fail("crop fragments: wrong launch count, plain attention or non-finite logits")
    if not covered.all() or pred.shape != (n_raw,):
        fail(f"the crops cover {int(covered.sum())} of {n_raw} raw points")
    if not all(0.0 <= v <= 1.0 for v in tester.result.values()):
        fail(f"crop tester metrics out of [0, 1]: {tester.result}")

    # the route gap: the first and the last crop through the kernel and the
    # plain route with one noise draw each, and their votes summed
    plain_cfg = copy.deepcopy(cfg)
    plain_cfg["backbone"]["use_pallas"] = False
    plain_model = build_model(plain_cfg, device="cuda")
    plain_model.load_state_dict(tester.model.state_dict())
    plain_tester = SemSegTester(tester.cfg, model=plain_model, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(7)
    votes_k = torch.zeros((n_raw, tester.cfg.data.num_classes), device="cuda")
    votes_p = torch.zeros_like(votes_k)
    gaps = []
    for i in (0, n_frag - 1):
        frag = scene["fragment_list"][i]
        bucket = pick_bucket(len(frag["coord"]), DEFAULT_BUCKETS)
        noise = torch.randn((bucket, 6), generator=gen, device="cuda")
        noise_fn = lambda index, b, c: noise
        pk = tester.predict_fragment(frag, i, noise_fn)
        pp = plain_tester.predict_fragment(frag, i, noise_fn)
        idx = torch.as_tensor(frag["index"], device="cuda")
        votes_k.index_add_(0, idx, pk)
        votes_p.index_add_(0, idx, pp)
        gaps.append(dict(fragment=i, max_abs_dp=(pk - pp).abs().max().item(),
                         argmax_agree=(pk.argmax(1) == pp.argmax(1)).float().mean().item()))
    # the voted probabilities: each point's mean over the crops holding it
    n_votes = votes_k.sum(1, keepdim=True)
    voted = n_votes[:, 0] > 0
    votes_k, votes_p = votes_k[voted] / n_votes[voted], votes_p[voted] / n_votes[voted]
    gaps.append(dict(fragment="voted", points=int(voted.sum().item()),
                     max_abs_dp=(votes_k - votes_p).abs().max().item(),
                     argmax_agree=(votes_k.argmax(1) == votes_p.argmax(1)).float()
                     .mean().item()))
    del plain_tester, plain_model, votes_k, votes_p
    torch.cuda.empty_cache()
    print("host crop route gap " + json.dumps(gaps), flush=True)
    if any(g["max_abs_dp"] > TOL_TEST[0] or g["argmax_agree"] < TOL_TEST[1] for g in gaps):
        fail("crop probabilities through the kernel disagree with the plain route")

    # ---- the visualizer: a coarse prediction lifted to the raw points ----
    room = torch.load(os.path.join(tmp, "data", "val", "scene0000_00.pth"),
                      weights_only=False)
    coord = np.asarray(room["coord"], np.float32)
    _, first = np.unique(np.floor(coord / REMAP_GRID).astype(np.int64), axis=0,
                         return_index=True)
    viz = os.path.join(tmp, "viz")
    np.save(os.path.join(tmp, "coarse_pred.npy"), pred[first])
    np.save(os.path.join(tmp, "coarse_coord.npy"), coord[first])
    t0 = time.perf_counter()
    visualize.main(["--scene", os.path.join(tmp, "data", "val", "scene0000_00.pth"),
                    "--pred", os.path.join(tmp, "coarse_pred.npy"), "--sampled-coord",
                    os.path.join(tmp, "coarse_coord.npy"), "--out", viz])
    viz_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    on_card = remap_to_origin(coord, coord[first], pred[first])
    card_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    on_cpu = remap_to_origin(coord, coord[first], pred[first], device="cpu")
    cpu_ms = (time.perf_counter() - t0) * 1e3
    save_segmentation(coord, on_cpu, os.path.join(tmp, "cpu_pred.ply"), 20)
    same_ply = (open(os.path.join(viz, "scene0000_00_pred.ply"), "rb").read()
                == open(os.path.join(tmp, "cpu_pred.ply"), "rb").read())
    viz_res = dict(sampled=len(first), raw_points=n_raw, cli_s=viz_s, remap_card_ms=card_ms,
                   remap_cpu_ms=cpu_ms, differing=int((on_card != on_cpu).sum()),
                   same_ply=same_ply, files=sorted(os.listdir(viz)),
                   agree_with_tester=float((on_cpu == pred).mean()))
    print("host visualize " + json.dumps(viz_res), flush=True)
    if viz_res["differing"] or not same_ply or len(read_ply(
            os.path.join(viz, "scene0000_00_pred.ply"))[0]) != n_raw:
        fail("the card's 1-NN lift of the coarse prediction differs from the CPU's")

    # ---- the trainer with the decode cache and RuntimeProfiler ----
    cache_dir = os.path.join(tmp, "cache")
    train_save = os.path.join(tmp, "host_train")
    data_root = os.path.join(tmp, "data")
    hook_cfg = [dict(type="IterationTimer", warmup_iter=1),
                dict(type="InformationWriter", log_interval=1), PROFILE]
    targv = ["--config-file", config, "--options", "epoch=2", "eval_epoch=2",
             f"save_path={train_save}", f"hooks={hook_cfg!r}", "data.train.cache=True",
             f"data.train.data_root={data_root}", f"data.val.data_root={data_root}"]
    steps, loads = [], []

    def timed_step(factory):
        def build(*args, **kwargs):
            step = factory(*args, **kwargs)

            @functools.wraps(step)
            def run(*a, **kw):
                torch.cuda.synchronize()
                before = (fa.patch_attention_fwd.launches, fa.patch_attention_bwd_dq.launches,
                          fa.patch_attention_bwd_dkdv.launches)
                t0 = time.perf_counter()
                out = step(*a, **kw)
                torch.cuda.synchronize()
                after = (fa.patch_attention_fwd.launches, fa.patch_attention_bwd_dq.launches,
                         fa.patch_attention_bwd_dkdv.launches)
                steps.append(dict(ms=(time.perf_counter() - t0) * 1e3,
                                  launches=[b - a for a, b in zip(before, after)],
                                  loss=float(out["loss"])))
                return out
            return run
        return build

    def timed_load(fn):
        def run(self, path):
            cached = self.cache and os.path.exists(cache_path(path))
            t0 = time.perf_counter()
            out = fn(self, path)
            loads.append(dict(path=path, s=time.perf_counter() - t0, cached=cached))
            return out
        return run

    old_dir = os.environ.get("CDSEG_CACHE_DIR")
    os.environ["CDSEG_CACHE_DIR"] = cache_dir
    try:
        cuda_build.reset_launch_counts()
        t0 = time.perf_counter()
        with patched((train_mod, "make_train_step", timed_step),
                     (datasets.DefaultDataset, "_load", timed_load)):
            trainer = train_tool.main(targv)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        train_paths = sorted(trainer.train_ds.data_list)
        files = sorted(os.listdir(cache_dir))
        want_files = sorted(os.path.basename(cache_path(p)) for p in train_paths)
        # the first bucket of the cached loader (read from the files the
        # run wrote) against the uncached loader's, same seed
        tcfg = Config.fromfile(config)
        tcfg.merge_from_dict(parse_options(targv[targv.index("--options") + 1:]))
        firsts = []
        for cache in (True, False):
            ds = datasets.build_dataset(dict(tcfg.data.train, cache=cache))
            loader = TrainLoader(ds, num_devices=1, scenes_per_device=tcfg.scenes_per_device,
                                 num_points=tcfg.bucket_num_points, mix_prob=tcfg.mix_prob,
                                 seed=tcfg.seed)
            epoch = loader.epoch(0)
            firsts.append(next(epoch))
            epoch.close()
    finally:
        if old_dir is None:
            os.environ.pop("CDSEG_CACHE_DIR", None)
        else:
            os.environ["CDSEG_CACHE_DIR"] = old_dir
    same_bucket = firsts[0].keys() == firsts[1].keys() and all(
        np.array_equal(np.asarray(firsts[0][k]), np.asarray(firsts[1][k])) for k in firsts[0])
    traces = glob.glob(os.path.join(train_save, "trace", "plugins", "profile", "*",
                                    "*.trace.json.gz"))
    profile = [ln.split("] ", 1)[1] for ln in
               open(os.path.join(train_save, "train.log")).read().splitlines()
               if "[profile]" in ln]
    # the hook logs its 20 heaviest names; the kernels are looked up among
    # the trace's 100 heaviest, with their rank
    ranked = summarize_trace(os.path.join(train_save, "trace"), 100)
    named = {k: [(rank + 1, name, dur / 1e3) for rank, (name, dur) in enumerate(ranked)
                 if k in name] for k in PROFILED_KERNELS}
    first_loads = [x["s"] for x in loads if not x["cached"]]
    later_loads = [x["s"] for x in loads if x["cached"]]
    train = dict(steps=len(steps), step_ms=[x["ms"] for x in steps],
                 profiled_step_ms=[x["ms"] for i, x in enumerate(steps) if i in (1, 2)],
                 unprofiled_step_ms=[x["ms"] for i, x in enumerate(steps) if i not in (1, 2)],
                 launches=[x["launches"] for x in steps], losses=[x["loss"] for x in steps],
                 cache_files=len(files), stray=sorted(set(files) - set(want_files)),
                 first_load_s=first_loads, later_load_s=later_loads,
                 same_first_bucket=same_bucket, trace_files=len(traces),
                 trace_mb=sum(os.path.getsize(t) for t in traces) / 2 ** 20,
                 profile_lines=len(profile), kernels_in_trace={
                     k: v[0] if v else None for k, v in named.items()},
                 wall_s=train_s)
    print("host cached trainer " + json.dumps(train), flush=True)
    if len(steps) != 4 or any(x["launches"] != [n_train_launches] * 3 for x in steps) or \
            not np.isfinite(train["losses"]).all():
        fail(f"the cached trainer's steps: {train['launches']}, losses {train['losses']}")
    if files != want_files:
        fail(f"the cache holds {files}, expected one file per scene {want_files}")
    if len(first_loads) != len(train_paths) or not later_loads:
        fail(f"cache loads: {len(first_loads)} decoded, {len(later_loads)} read")
    if not same_bucket:
        fail("the cached loader's first bucket differs from the uncached one's")
    if len(traces) != 1 or not profile or not all(named.values()):
        fail(f"trace files {traces}, {len(profile)} summary lines; the trace names {named}")
    result = dict(crop=dict(crop, route_gaps=gaps), visualize=viz_res, train=train,
                  phase_s=time.perf_counter() - start, card=card)
    print("host " + json.dumps(dict(phase_s=result["phase_s"], card=card)), flush=True)
    return result


CONV_KINDS = ("fwd", "dgrad", "wgrad")


@contextlib.contextmanager
def recorded_convs(sc, model, calls):
    """While open, observe each submanifold conv of ``model`` that runs
    the kernels, from forward hooks (the launch path is left as it is):
    ``(table, C_in, C_out, dtype, input needs a gradient)`` in ``calls``.
    A `SubMConv` ran them when its output comes from the kernels' autograd
    Function; a `DualEmbedding` (bf16) when the forward kernel's counter
    moved."""
    from cdsegnet_torch.models.modules import SubMConv
    from cdsegnet_torch.models.ptv3 import DualEmbedding

    def arg(args, kwargs, i, name):
        return args[i] if len(args) > i else kwargs[name]

    def on_conv(module, args, kwargs, out):
        if isinstance(out.grad_fn, sc._SubMConvGemm._backward_cls):
            feat = arg(args, kwargs, 0, "feat")
            _, c_in, c_out = module.weight.shape
            calls.append((arg(args, kwargs, 1, "neighbor_idx"), c_in, c_out, module.dtype,
                          feat.requires_grad))

    def before_stem(module, args, kwargs):
        module._conv_fwd_before = sc.subm_conv_gemm_fwd.launches

    def on_stem(module, args, kwargs, out):
        if sc.subm_conv_gemm_fwd.launches > module._conv_fwd_before:
            n_feat, c_feat = arg(args, kwargs, 0, "n_feat"), arg(args, kwargs, 1, "c_feat")
            c_in = module.n_weight.shape[1] + module.c_weight.shape[1]
            c_out = module.n_weight.shape[2] + module.c_weight.shape[2]
            calls.append((arg(args, kwargs, 3, "stem_neighbor"), c_in, c_out, module.dtype,
                          n_feat.requires_grad or c_feat.requires_grad))

    handles = []
    for m in model.modules():
        if isinstance(m, SubMConv):
            handles.append(m.register_forward_hook(on_conv, with_kwargs=True))
        elif isinstance(m, DualEmbedding):
            handles.append(m.register_forward_pre_hook(before_stem, with_kwargs=True))
            handles.append(m.register_forward_hook(on_stem, with_kwargs=True))
    try:
        yield calls
    finally:
        for h in handles:
            h.remove()


def conv_launches(torch, calls):
    """The kernels' launches that ``calls`` make: a weight gradient each, an
    input gradient where the input needs one, a forward each in bf16 (f32
    convs forward by gather + matmul, `subm_conv._forward`)."""
    out = collections.Counter(wgrad=len(calls))
    out["dgrad"] = sum(1 for c in calls if c[4])
    out["fwd"] = sum(1 for c in calls if c[3] == torch.bfloat16)
    return out


def conv_rows(torch, sc, calls):
    """Per distinct (table, C_in, C_out, dtype) of ``calls``: its launches
    per step by kind, and the kernels' times (CUDA events) on random inputs
    of its shape beside the bound, the plain version (gather + matmul,
    forward and autograd's backward) and the dense product of the gathered
    rows (``torch.matmul``, the yardstick)."""
    shapes = collections.OrderedDict()
    for call in calls:
        nbr, c_in, c_out, dtype = call[:4]
        key = (nbr.data_ptr(), tuple(nbr.shape), c_in, c_out, dtype)
        shapes.setdefault(key, dict(nbr=nbr.to(torch.int32).contiguous(),
                                    launches=collections.Counter()))
        shapes[key]["launches"].update(conv_launches(torch, [call]))
    rows = []
    gen = torch.Generator(device="cuda").manual_seed(0)
    for (_, (n, k), c_in, c_out, dtype), entry in shapes.items():
        nbr = entry["nbr"]
        name = "bfloat16" if dtype == torch.bfloat16 else "float32"
        x = torch.randn((n, c_in), device="cuda", generator=gen).to(dtype)
        w = torch.randn((k, c_in, c_out), device="cuda", generator=gen) / (k * c_in) ** 0.5
        dy = torch.randn((n, c_out), device="cuda", generator=gen).to(dtype)
        taps = torch.empty((-(-n // sc.TILE_ROWS), k), dtype=torch.uint8, device="cuda")
        y = sc.subm_conv_gemm_fwd(x, nbr, w, tile_taps=taps)
        want = sc._plain_conv(x, nbr, w, None)
        dx = sc.subm_conv_gemm_dgrad(dy, nbr, w)
        want_dx = sc._plain_conv(dy, nbr, sc.reflected_weight(w).contiguous(), None)
        dw = sc.subm_conv_gemm_wgrad(x, nbr, dy, taps)
        gathered = torch.cat([x, x.new_zeros((1, c_in))])[nbr.long()].reshape(n, k * c_in)
        want_dw = (gathered.float().T @ dy.float()).reshape(k, c_in, c_out)
        err = {key: ((a.float() - b.float()).abs().max() / b.float().abs().max()).item()
               for key, a, b in (("fwd", y, want), ("dgrad", dx, want_dx),
                                 ("wgrad", dw, want_dw))}
        tol = TOL_CONV[name]
        if not all(e <= tol[key] for key, e in err.items()):
            fail(f"conv kernels against the plain version at {(n, k, c_in, c_out, name)}: {err}")
        pairs = int((nbr < n).sum().item())
        size = x.element_size()
        flops = 2 * pairs * c_in * c_out
        table_bytes = n * k * 4
        bounds = dict(
            fwd=shape_bound(flops, (n * (c_in + c_out) + k * c_in * c_out) * size + table_bytes,
                            name),
            dgrad=shape_bound(flops, (n * (c_in + c_out) + k * c_in * c_out) * size
                              + table_bytes, name),
            wgrad=shape_bound(flops, n * (c_in + c_out) * size + k * c_in * c_out * 4
                              + table_bytes, name))
        times = dict(fwd=cuda_ms(torch, lambda: sc.subm_conv_gemm_fwd(x, nbr, w, tile_taps=taps)),
                     dgrad=cuda_ms(torch, lambda: sc.subm_conv_gemm_dgrad(dy, nbr, w)),
                     wgrad=cuda_ms(torch, lambda: sc.subm_conv_gemm_wgrad(x, nbr, dy, taps)))
        xp, wp = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
        plain_ms = cuda_ms(torch, lambda: torch.autograd.grad(
            sc._plain_conv(xp, nbr, wp, None), (xp, wp), dy), warmup=1, iters=3)
        wf = w.to(dtype).reshape(k * c_in, c_out)
        library_ms = cuda_ms(torch, lambda: gathered @ wf)
        row = dict(n=n, k=k, c_in=c_in, c_out=c_out, dtype=name, pairs=pairs,
                   tile_tap_share=sc.tile_tap_share(nbr), launches=dict(entry["launches"]),
                   max_rel_err=err, ms=times,
                   bound_ms={d: b["bound_ms"] for d, b in bounds.items()},
                   bound_by={d: b["bound_by"] for d, b in bounds.items()},
                   plain_fwd_bwd_ms=plain_ms, library_fwd_ms=library_ms)
        print("conv shape " + json.dumps(row), flush=True)
        rows.append(row)
        del x, dy, gathered, y, want, dx, want_dx
        torch.cuda.empty_cache()
    return rows


def conv_step_sums(rows):
    """Per training step: the kernels' ms by kind, their bound, the plain
    version's forward and backward and the dense yardstick's forward (f32
    steps run the plain forward: their ``fwd_ms`` is 0)."""
    out = {}
    for kind in ("fwd", "dgrad", "wgrad"):
        out[f"{kind}_ms"] = sum(r["ms"][kind] * r["launches"].get(kind, 0) for r in rows)
        out[f"{kind}_bound_ms"] = sum(r["bound_ms"][kind] * r["launches"].get(kind, 0)
                                      for r in rows)
    # one weight gradient per conv of the step
    out["plain_fwd_bwd_ms"] = sum(r["plain_fwd_bwd_ms"] * r["launches"]["wgrad"] for r in rows)
    out["library_fwd_ms"] = sum(r["library_fwd_ms"] * r["launches"]["wgrad"] for r in rows)
    return out


def phase_conv(torch, conf, point, card):
    """Phase 23: the submanifold conv's implicit-GEMM kernels at the
    training cells' shapes. One training step each of SpUNet (f32, its
    shipped config) and the flagship (bf16) counts the kernels' launches
    (forward, input gradient, weight gradient) on the wrappers' counters,
    set to 0 before the step, and holds them to the convs that forward
    hooks saw run with their tables and widths: one weight gradient per
    conv, an input gradient for all but the stems (the flagship's dual
    stem among them: one weight gradient more than input gradients), a
    forward per conv in bf16 and none in f32 (`subm_conv._forward`). Each distinct
    shape (the f32 forward kernel included: the input gradient runs it) is
    then checked against the plain
    version and timed beside its bound, the plain version and the dense
    yardstick; sums per step."""
    from cdsegnet_torch.engine.state import make_train_step
    from cdsegnet_torch.ops import subm_conv as sc

    from cdsegnet_torch.engine.optimizer import build_optimizer
    from cdsegnet_torch.models.builder import build_model, build_model_criteria
    from cdsegnet_torch.utils import cuda_build

    res = dict(card=card)
    for name, c in (("spunet", load_config(SPARSE_CONFIGS["spunet"])), ("cdsegnet", conf)):
        model_cfg = copy.deepcopy(dict(c["model"]))
        model = build_model(model_cfg, device="cuda", generator=torch.Generator().manual_seed(0))
        criteria = build_model_criteria(model_cfg)
        opt = build_optimizer(dict(c["optimizer"]), model, dict(c["scheduler"]),
                              total_steps=TRAIN_TOTAL_STEPS,
                              param_dicts=[dict(p) for p in c.get("param_dicts", [])],
                              clip_keywords=c.get("gredient_clip", []), device="cuda")
        step = make_train_step(model, criteria, opt, seed=0, device="cuda")
        step(point)  # the first step builds what it caches
        torch.cuda.synchronize()
        calls = []
        cuda_build.reset_launch_counts()
        with recorded_convs(sc, model, calls):
            step(point)
            torch.cuda.synchronize()
        # the wrappers' own counters, against what the observed convs launch
        counts = {kind: getattr(sc, f"subm_conv_gemm_{kind}").launches for kind in CONV_KINDS}
        want = conv_launches(torch, calls)
        tables = sorted({tuple(c[0].shape) for c in calls})
        print(f"conv {name} launches per step {counts} (observed convs {dict(want)}), "
              f"tables {tables}", flush=True)
        # bf16 forwards through the kernel, f32 through gather + matmul
        fwd = counts["wgrad"] if name == "cdsegnet" else 0
        if counts != {kind: want[kind] for kind in CONV_KINDS} or not counts["wgrad"] \
                or counts["fwd"] != fwd or not 0 < counts["dgrad"] <= counts["wgrad"]:
            fail(f"{name}: conv launches per step {counts}, the observed convs {dict(want)}")
        # the flagship's dual stem ("cond") runs the kernels too: its one
        # conv whose inputs need no gradient
        if name == "cdsegnet" and counts["wgrad"] - counts["dgrad"] != 1:
            fail(f"cdsegnet: the stem did not run the conv kernels: {counts}")
        del step, opt, model, criteria
        torch.cuda.empty_cache()
        rows = conv_rows(torch, sc, calls)
        res[name] = dict(launches=dict(counts), per_step=conv_step_sums(rows),
                         shapes=len(rows))
        print(f"conv {name} per step " + json.dumps(res[name]), flush=True)
    print("conv " + json.dumps(res), flush=True)
    return res


def step_sums(rows, direction):
    """bf16 sums per training step in ``direction`` over the rows' launches,
    each timed on its level's real scene ids and validity."""
    main = [r for r in rows if r["dtype"] == "bfloat16"]
    per_step = lambda key: sum(r[direction][key] * r["launches_per_step"] for r in main)
    errs = {"fwd": ("o", "lse"), "dq": ("dq",), "dkdv": ("dk", "dv")}[direction]
    return dict(
        max_abs_err=max(r["max_abs_err"][e] for r in main for e in errs),
        ms=per_step("ms"), plain_ms=per_step("plain_ms"), bound_ms=per_step("bound_ms"),
        bound_by="operations" if per_step("ops_ms") >= per_step("bytes_ms") else "bytes",
        library_ms=per_step("library_ms"))


class PhaseClock:
    """Prints the wall time of each phase since the previous mark."""

    def __init__(self, start: float):
        self.last = start

    def __call__(self, name: str) -> None:
        now = time.perf_counter()
        print(f"phase {name} wall {now - self.last:.1f} s", flush=True)
        self.last = now


def kernel_entry(name, source, replaces, launches, rows, direction):
    """One entry of the kernels line: `step_sums` over the main path's
    training step."""
    return dict(name=name, route="cuda", source=source, replaces=replaces,
                launches=launches, **step_sums(rows, direction))


def main() -> int:
    start = time.perf_counter()
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    config = os.path.join(ROOT, "configs", "scannet", "cdsegnet.py")
    runtime = os.path.join(ROOT, "configs", "_base_", "default_runtime.py")
    if not os.path.isdir(os.path.join(ROOT, "cdsegnet_torch")) or not os.path.isfile(config):
        print("chip_smoke: run from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        return run_phases(torch, config, runtime, tmp, start)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def run_phases(torch, config: str, runtime: str, tmp: str, start: float) -> int:
    """Every phase, in order; ``tmp`` holds the tester's scene and outputs."""
    from cdsegnet_torch.ops import subm_conv
    from cdsegnet_torch.ops.flash_attention import BWD_KERNEL, KERNEL
    from cdsegnet_torch.ops.flash_attention import SOURCES as ATTENTION_SOURCES
    from cdsegnet_torch.utils import cuda_build

    sources = ATTENTION_SOURCES + (subm_conv.KERNEL,)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = card_line()
    print(f"card {card}", flush=True)
    clock = PhaseClock(start)

    took = cuda_build.build(*sources)
    for name in sources:
        print(f"build {name} in {took[name]:.1f} s", flush=True)
        for line in cuda_build.build_log(name).splitlines():
            if "registers" in line or "spill" in line or "entry function" in line:
                print(f"build ptxas {name}: {line.strip()}", flush=True)
            if re.search(r"[1-9]\d* bytes spill", line):
                fail(f"{name} spills registers: {line.strip()}")
    hmma = {}
    for name in sources:
        for fn, count in sorted(cuda_build.sass_counts(name, "HMMA").items()):
            print(f"build sass {name}: HMMA {count} in {fn}", flush=True)
            hmma[fn] = count
    for kernel in ("fwd_mma_kernel", "bwd_dq_mma_kernel", "bwd_dkdv_mma_kernel",
                   "subm_conv_gemm_fwd_mma", "subm_conv_gemm_wgrad_mma"):
        if not any(kernel in fn and count > 0 for fn, count in hmma.items()):
            fail(f"the bf16 {kernel} has no tensor-core instruction")
    clock("build")

    from cdsegnet_torch.data.collate import collate_scenes, pick_bucket
    from cdsegnet_torch.engine.state import batch_to_point
    from cdsegnet_torch.engine.test import DEFAULT_BUCKETS
    from cdsegnet_torch.models.builder import build_model
    from cdsegnet_torch.utils.synthetic import synthetic_point_batch

    conf = runpy.run_path(config)
    depth = runpy.run_path(runtime)["serialization_depth"]
    cfg = conf["model"]
    model = build_model(cfg, device="cuda",
                        generator=torch.Generator().manual_seed(0))
    point = synthetic_point_batch(NUM_POINTS, 1, depth=10, seed=0, device="cuda")
    levels, _ = model.backbone.precompute_geometry(point)
    drops = [lv.dropped for lv in levels[1:]]
    n_valid = int(point.mask.sum().item())
    print(f"scene {NUM_POINTS} points, {n_valid} valid, level sizes "
          f"{[lv.size for lv in levels]}, dropped per level {drops}", flush=True)
    if drops != [0, 0, 0, 0] or n_valid != 94003:
        fail("the bench scene is not the expected one")

    patch = max(cfg["backbone"]["n_enc_patch_size"])
    launches = attention_launches(cfg["backbone"])
    rows = phase_kernels(torch, levels, launches, patch)
    # the c-decoder (DDIM and phase 21's dual-branch PPT run it): its
    # launches on the bench scene's levels
    c_dec = attention_launches(cfg["backbone"], c_decoder=True)[len(launches):]
    ppt_rows = rows + phase_kernels(torch, levels, c_dec, patch, path="ppt")
    # the tester's shapes: the levels of the room scene's first fragment
    n_raw, test_scene = tester_scene(torch, config, tmp)
    frag = test_scene["fragment_list"][0]
    bucket = pick_bucket(len(frag["coord"]), DEFAULT_BUCKETS)
    # phase 16's multistep fragment
    frag_point = batch_to_point(collate_scenes([frag], bucket, 1), depth, 1, "cuda")
    frag_levels, _ = model.backbone.precompute_geometry(frag_point)
    print(f"test fragment 0: {len(frag['coord'])} points in the {bucket} bucket, level "
          f"sizes {[lv.size for lv in frag_levels]}, dropped per level "
          f"{[lv.dropped for lv in frag_levels[1:]]}", flush=True)
    test_rows = phase_kernels(torch, frag_levels, launches, patch, path="test")
    # phase 22's covering crops: the levels of the room's first crop
    c_scene = crop_scene(config, tmp)
    crop = c_scene["fragment_list"][0]
    bucket = pick_bucket(len(crop["coord"]), DEFAULT_BUCKETS)
    lv, _ = model.backbone.precompute_geometry(
        batch_to_point(collate_scenes([crop], bucket, 1), depth, 1, "cuda"))
    print(f"crop fragment 0: {len(crop['coord'])} points in the {bucket} bucket, level "
          f"sizes {[x.size for x in lv]}, dropped per level {[int(x.dropped) for x in lv[1:]]}",
          flush=True)
    crop_rows = phase_kernels(torch, lv, launches, patch, path="crop")
    del lv
    # DDIM runs the c-decoder in eval mode: its launches on the same levels
    cdec_rows = phase_kernels(torch, frag_levels, c_dec, patch, path="ddim")
    del frag_levels
    # the trainer's validation shapes: the val room in the 524,288-slot bucket
    # (the plain version keeps 4 GiB of probabilities at level 0 there)
    val_levels = eval_levels(torch, config, model, tmp, depth)
    eval_rows = phase_kernels(torch, val_levels, launches, patch, path="eval")
    del val_levels
    torch.cuda.empty_cache()
    # the timing protocol's whole-scene fragments, depth 12 as shipped
    time_root = time_rooms(tmp)
    time_rows = {}
    for frag in time_fragments(time_root):
        bucket = pick_bucket(len(frag["coord"]), DEFAULT_BUCKETS)
        lv, _ = model.backbone.precompute_geometry(
            batch_to_point(collate_scenes([frag], bucket, 1), depth, 1, "cuda"))
        print(f"time fragment: {len(frag['coord'])} points in the {bucket} bucket, "
              f"largest grid coordinate {int(frag['grid_coord'].max())}, level sizes "
              f"{[x.size for x in lv]}, dropped per level {[int(x.dropped) for x in lv[1:]]}",
              flush=True)
        time_rows[bucket] = phase_kernels(torch, lv, launches, patch, path=f"time{bucket}")
        del lv
        torch.cuda.empty_cache()
    # the nuScenes sweep's SSI shapes (the same backbone structure)
    nus = nuscenes_data(torch, tmp, depth)
    lv, _ = model.backbone.precompute_geometry(nus[2])
    print(f"nuscenes ssi batch: level sizes {[x.size for x in lv]}, dropped per level "
          f"{[int(x.dropped) for x in lv[1:]]}", flush=True)
    nus_rows = phase_kernels(torch, lv, launches, patch, path="nuscenes")
    del lv
    clock("kernels")
    ssi = phase_ssi(torch, cfg, model, point, len(launches), card)
    clock("ssi")
    # per forward: summed over the path's launches, each timed on its
    # level's real scene ids and validity
    print("ssi kernel per forward " + json.dumps(forward_sums(rows)), flush=True)
    print("test kernel per fragment " + json.dumps(forward_sums(test_rows)), flush=True)
    print("eval kernel per forward " + json.dumps(forward_sums(eval_rows)), flush=True)
    del model, levels
    torch.cuda.empty_cache()

    # the training bucket: scenes_per_device x num_points_per_scene slots at
    # the runtime's serialization depth
    n_train, n_scenes = conf["bucket_num_points"], conf["scenes_per_device"]
    train_point = synthetic_point_batch(n_train, n_scenes, depth=depth, seed=0,
                                        device="cuda")
    train_model = build_model(cfg, device="cuda",
                              generator=torch.Generator().manual_seed(0))
    train_levels, _ = train_model.backbone.precompute_geometry(train_point)
    print(f"train bucket {n_train} slots, {n_scenes} scenes, depth {depth}, "
          f"{int(train_point.mask.sum().item())} valid, level sizes "
          f"{[lv.size for lv in train_levels]}, dropped per level "
          f"{[lv.dropped for lv in train_levels[1:]]}", flush=True)
    train_launches = attention_launches(cfg["backbone"], c_decoder=True)
    train_rows = phase_train_kernels(torch, train_levels, train_launches, patch)
    lv, _ = train_model.backbone.precompute_geometry(nus[1])
    print(f"nuscenes train bucket: level sizes {[x.size for x in lv]}, dropped per level "
          f"{[int(x.dropped) for x in lv[1:]]}", flush=True)
    nus_train_rows = phase_train_kernels(torch, lv, train_launches, patch, path="nuscenes")
    # phase 13's micro buckets: half the slots, one scene each
    micros = [synthetic_point_batch(n_train // 2, n_scenes // 2, depth=depth, seed=s,
                                    device="cuda") for s in MICRO_SEEDS]
    micro_rows = []  # both micros' rows: a microbatch-2 step runs each once
    for i, micro_point in enumerate(micros):
        lv, _ = train_model.backbone.precompute_geometry(micro_point)
        print(f"micro bucket {i}: {n_train // 2} slots, {n_scenes // 2} scene, "
              f"{int(micro_point.mask.sum().item())} valid, level sizes "
              f"{[x.size for x in lv]}, dropped per level "
              f"{[int(x.dropped) for x in lv[1:]]}", flush=True)
        micro_rows += phase_train_kernels(torch, lv, train_launches, patch,
                                          path=f"micro{i}")
    del train_model, train_levels, lv
    torch.cuda.empty_cache()
    clock("train kernels")
    train = phase_train(torch, conf, cfg, train_point, len(train_launches), card)
    torch.cuda.empty_cache()
    clock("train")
    phase_train_gap(torch, conf, cfg)
    torch.cuda.empty_cache()
    clock("train route gap")
    test = phase_test(torch, config, cfg, tmp, n_raw, test_scene, len(launches), card)
    del test_scene
    torch.cuda.empty_cache()
    clock("test")
    train_cli = phase_train_cli(torch, config, tmp, len(train_launches), len(launches),
                                card)
    torch.cuda.empty_cache()
    clock("train cli")
    gap_point = synthetic_point_batch(GAP_POINTS, 1, depth=12, seed=1, device="cuda")
    variants = phase_variants(torch, point, gap_point, train_point, nus, card)
    phase_nuscenes_test(torch, nus, len(launches), card)
    del nus
    torch.cuda.empty_cache()
    clock("variants")
    ckpt = os.path.join(tmp, "exp", "model", "model_last")  # phase 8's checkpoint
    timing = phase_time(torch, config, time_root, ckpt, len(launches), card)
    clock("time")
    ddim = phase_ddim(torch, config, cfg, tmp, ckpt, len(train_launches), card)
    clock("ddim")
    micro = phase_micro(torch, conf, cfg, micros, len(train_launches), train["peak_mem_gib"],
                        card)
    del micros
    clock("micro")
    ranks = phase_ranks(torch, config, cfg, tmp, ckpt, len(train_launches), len(launches),
                        card)
    clock("ranks")
    options = phase_options(torch, conf, cfg, point, gap_point, train_point, card)
    clock("options")
    ablations = phase_ablations(torch, config, conf, cfg, tmp, point, gap_point, train_point,
                                frag_point, n_raw, card)
    del gap_point, frag_point
    torch.cuda.empty_cache()
    clock("ablations")
    ptv2 = phase_ptv2(torch, point, train_point, card)
    torch.cuda.empty_cache()
    clock("ptv2")
    phase_shapes(torch, tmp, card)
    clock("shapes")
    sparse = phase_sparse(torch, point, train_point, tmp, card)
    torch.cuda.empty_cache()
    clock("sparse")
    zoo = phase_zoo(torch, point, train_point, tmp, n_raw, card)
    torch.cuda.empty_cache()
    clock("zoo")
    msc = phase_msc(torch, tmp, card)
    clock("msc")
    ppt = phase_ppt(torch, point, train_point, tmp, card)
    torch.cuda.empty_cache()
    clock("ppt")
    conv = phase_conv(torch, conf, train_point, card)
    del point, train_point
    torch.cuda.empty_cache()
    clock("conv")
    host = phase_host(torch, config, cfg, tmp, ckpt, n_raw, c_scene, len(launches),
                      len(train_launches), card)
    del c_scene
    torch.cuda.empty_cache()
    clock("host")
    # this slice's paths through the kernels: times from phases 3 and 5 (the
    # same levels, heads and head dims), launches counted in phases 15-16
    kernel_models = {f"option_{n}": option_cfg(cfg, n)["backbone"] for n in ("a", "b")}
    kernel_models.update({k: ablation_cfg(cfg, k)["backbone"] for k in ABLATIONS})
    slice_runs = {f"option_{n}": options[n] for n in ("a", "b")}
    slice_runs.update({k: ablations[k] for k in ABLATIONS})

    tpu = "cdsegnet_tpu/ops/pallas/flash_attention.py"
    bwd_src = f"cdsegnet_torch/csrc/{BWD_KERNEL}.cu"
    kernels = [
        dict(kernel_entry("patch_attention_fwd", f"cdsegnet_torch/csrc/{KERNEL}.cu",
                          f"{tpu}:45", train["launches"]["fwd"], train_rows, "fwd"),
             # the other paths through the forward: launches counted on each
             # path's run, times per SSI forward and per tester fragment
             paths=dict(ssi=dict(forward_sums(rows), launches=ssi["launches"]),
                        test=dict(forward_sums(test_rows), launches=test["launches"],
                                  fragments=test["fragments"],
                                  per_fragment=test["per_fragment"]),
                        # per covering crop of phase 22's tester: times from
                        # phase 3 (the first crop's levels), launches counted
                        # in phase 22's run
                        crop=dict(forward_sums(crop_rows), launches=host["crop"]["launches"],
                                  fragments=host["crop"]["fragments"],
                                  per_fragment=host["crop"]["per_fragment"]),
                        # per validation SSI at the 524,288-slot bucket: times
                        # from phase 3, launches counted in phase 9's runs
                        eval=dict(forward_sums(eval_rows),
                                  launches=train_cli["launches_per_eval"],
                                  ssi_ms=train_cli["eval_ssi_ms"]),
                        # per SSI of each variant: times from phase 3 (the
                        # bench scene's rows, or the sweep's), launches
                        # counted in phase 10
                        variants={name: dict(
                            forward_sums(nus_rows) if name == NUSCENES else launch_sums(
                                rows, attention_launches(load_config(name).model.backbone)),
                            launches=v["ssi_launches"], ssi_ms=v["ssi_ms"],
                            step_launches=v["step_launches"]["fwd"])
                            for name, v in variants.items()},
                        # per whole-scene fragment: times from phase 3,
                        # launches counted in phase 11's runs
                        time={str(bucket): dict(
                            forward_sums(r), launches=sorted({
                                f["launches"] for run in ("depth12", "depth16")
                                for f in timing[run]["fragments"] if f["bucket"] == bucket}),
                            ssi_ms={run: [f["ms"] for f in timing[run]["fragments"]
                                          if f["bucket"] == bucket][0]
                                    for run in ("depth12", "depth16")})
                            for bucket, r in time_rows.items()},
                        # per DDIM forward (c-decoder included): times from
                        # phase 3; launches per MSAI fragment from phase 12
                        ddim=dict(forward_sums(test_rows + cdec_rows),
                                  launches=ddim["per_fragment"],
                                  fragments=ddim["fragments"],
                                  fragment_ms=ddim["ms_median"]),
                        # per microbatch-2 step: times from phase 5 (each
                        # micro bucket's rows), launches from phase 13
                        micro=dict(step_sums(micro_rows, "fwd"),
                                   launches=micro["launches"]["fwd"]),
                        # per tester fragment on phase 14's ranks: times from
                        # phase 3 (the fragment rows), launches per rank
                        ranks=dict(forward_sums(test_rows),
                                   launches=ranks["test"]["gloo2"]["launches"],
                                   fragments=ranks["test"]["fragments"]),
                        # per SSI on phase 4's scene and per training step of
                        # each option and ablation model
                        slice_ssi={n: dict(launch_sums(rows, attention_launches(bb)),
                                           launches=slice_runs[n]["ssi_launches"]["fwd"],
                                           ssi_ms=slice_runs[n]["ssi_ms"])
                                   for n, bb in kernel_models.items()},
                        slice_train={n: dict(
                            train_launch_sums(train_rows, attention_launches(
                                bb, c_decoder=True), "fwd"),
                            launches=slice_runs[n]["step_launches"]["fwd"])
                            for n, bb in kernel_models.items()},
                        # per DDIM forward of each ablation (c-decoder
                        # included; DM has one branch): times from phase 3's
                        # fragment rows; launches per MSAI fragment of 6
                        ablation_msai={k: dict(
                            forward_sums(test_rows + cdec_rows) if k != "DMSegmentor"
                            else launch_sums(test_rows, attention_launches(
                                kernel_models[k])),
                            forwards=ABLATION_MSAI_STEPS + 1,
                            launches=ablations[k]["multistep"]["avg"]["launches"],
                            fragment_ms=ablations[k]["multistep"]["avg"]["ms"])
                            for k in ABLATIONS},
                        # phase 19's sparse-conv family and phase 20's
                        # zoo run no attention kernel
                        sparse=dict(launches=sparse["attention_launches"]["fwd"]),
                        zoo=dict(launches=zoo["attention_launches"]["fwd"]),
                        # phase 21: the dual-branch PPT's eval forward on
                        # phase 4's scene (times from phase 3's levels, the
                        # c-decoder included) and training step (times from
                        # phase 5); MSC and PPT over SpUNet launch none
                        ppt=dict(eval=dict(forward_sums(ppt_rows),
                                           launches=ppt["dual"]["eval_launches"],
                                           eval_ms=ppt["dual"]["eval_ms"]),
                                 train=dict(train_launch_sums(train_rows, train_launches,
                                                              "fwd"),
                                            launches=ppt["dual"]["step_launches"]["fwd"],
                                            step_ms=ppt["dual"]["step_ms"]),
                                 msc=dict(launches=msc["attention_launches"]),
                                 spunet=dict(launches=ppt["spunet_attention_launches"])))),
    ]
    for name, direction in (("patch_attention_bwd_dq", "dq"),
                            ("patch_attention_bwd_dkdv", "dkdv")):
        counted = "bwd_dq" if direction == "dq" else "bwd_dkdv"
        kernels.append(dict(
            kernel_entry(name, bwd_src, f"{tpu}:146", train["launches"][counted],
                         train_rows, direction),
            # per training step of each variant: times from phase 5 (the
            # bucket's rows, or the nuScenes batch's), launches from phase 10
            paths=dict(variants={v: dict(
                train_launch_sums(nus_train_rows if v == NUSCENES else train_rows,
                                  attention_launches(load_config(v).model.backbone,
                                                     c_decoder=True), direction),
                launches=r["step_launches"][counted]) for v, r in variants.items()},
                micro=dict(step_sums(micro_rows, direction),
                           launches=micro["launches"][counted]),
                slice_train={n: dict(train_launch_sums(train_rows, attention_launches(
                    bb, c_decoder=True), direction), launches=slice_runs[n]["step_launches"][
                        counted]) for n, bb in kernel_models.items()},
                sparse=dict(launches=sparse["attention_launches"][counted]),
                zoo=dict(launches=zoo["attention_launches"][counted]),
                ppt=dict(train_launch_sums(train_rows, train_launches, direction),
                         launches=ppt["dual"]["step_launches"][counted]))))
    # the submanifold conv's kernels replace no TPU kernel (the JAX package
    # gathers and multiplies through XLA): per training step of phase 23
    for kind in ("fwd", "dgrad", "wgrad"):
        kernels.append(dict(
            name=f"subm_conv_gemm_{kind}", route="cuda",
            source=f"cdsegnet_torch/csrc/{subm_conv.KERNEL}.cu", replaces=None,
            paths={m: dict(launches=conv[m]["launches"].get(kind, 0),
                           ms=conv[m]["per_step"][f"{kind}_ms"],
                           bound_ms=conv[m]["per_step"][f"{kind}_bound_ms"])
                   for m in ("spunet", "cdsegnet")}))
    kernels.append(knn_entry(ptv2))
    print(f"wall time {time.perf_counter() - start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
