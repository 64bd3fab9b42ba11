"""Trainer: the epoch loop with the hook lifecycle over the training step.

Port of `DefaultTrainer` of `cdsegnet_tpu/engine/train.py` (reference
`pointcept/engines/train.py:34-372`): ``cfg.eval_epoch`` (or ``cfg.epoch``)
evaluated epochs, each of ``loop = epoch // eval_epoch`` passes over the
train set; OneCycle over ``steps_per_epoch * max_epoch`` steps of the global
batch; the `TrainLoader` with Mix3D and prefetch; SSI validation at the
`EvalLoader`'s bucket; checkpoints under ``<save_path>/model`` that carry
the model, the optimizer and every rank's generators, so that a resumed run
continues the same draws.

Data parallelism: ``num_devices`` is the size of the process group the
trainer runs in (`parallel.dist`; `tools/train.py --num-gpus` or
``torchrun`` builds it), one rank per GPU, each loading its own bucket and
averaging gradients, loss and running statistics with the others every
step. The logger's file, the metric and event files and the checkpoints
belong to rank 0. ``microbatch`` m > 1 trains each rank's bucket as m micro
buckets in turn (JAX's gradient accumulation). A rank runs on
``cuda:<local_rank>`` (one process: the GPU) unless ``device`` names
another device, and raises when there is no GPU and none is named;
``num_devices`` > 1 without a process group raises.

A val dataset's ``condition`` (PPT) names the model's condition that the
validation forward takes; a model without ``conditions`` ignores it, as
JAX's does. `MSCTrainer` pretrains MSC on two collated views per scene,
with no microbatch, as JAX's. `MultiDatasetTrainer` trains PPT jointly on
the sub-datasets of a ``ConcatDataset`` config through `MultiDatasetLoader`
(each sub-dataset's ``loop`` its round-robin ratio), one step per
condition, chosen by the batch's ``_dataset_idx``; the steps share one set
of generators.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional, Union

import torch

from cdsegnet_torch.data.datasets import build_dataset
from cdsegnet_torch.data.loader import EvalLoader, MultiDatasetLoader, TrainLoader
from cdsegnet_torch.engine.checkpoint import CheckpointManager
from cdsegnet_torch.engine.events import EventStorage
from cdsegnet_torch.engine.hooks import build_hooks
from cdsegnet_torch.engine.optimizer import build_optimizer
from cdsegnet_torch.engine.state import (batch_to_point, make_eval_step,
                                         make_msc_train_step, make_train_step, msc_inputs)
from cdsegnet_torch.models.builder import build_model, build_model_criteria
from cdsegnet_torch.parallel import dist
from cdsegnet_torch.utils.device import resolve_device
from cdsegnet_torch.utils.logger import get_root_logger
from cdsegnet_torch.utils.registry import Registry

TRAINERS = Registry("trainers")

DEFAULT_HOOKS = [
    dict(type="CheckpointLoader"),
    dict(type="IterationTimer", warmup_iter=2),
    dict(type="InformationWriter"),
    dict(type="SemSegEvaluator"),
    dict(type="CheckpointSaver", save_freq=1),
]


@TRAINERS.register_module("DefaultTrainer")
class Trainer:
    takes_microbatch = True  # MSC's pair loader and step take none

    def __init__(self, cfg, device: Optional[Union[str, torch.device]] = None):
        self.cfg = cfg
        self.num_devices = cfg.get("num_devices") or dist.world_size()
        if self.num_devices != dist.world_size():
            if not dist.is_initialized():
                raise RuntimeError(
                    f"num_devices={self.num_devices}: training on more than one GPU "
                    "needs a process group (tools/train.py --num-gpus, or torchrun)")
            raise ValueError(f"num_devices={self.num_devices} in a process group of "
                             f"{dist.world_size()}")
        self.rank = dist.rank()
        self.device = (dist.rank_device(device) if dist.is_initialized()
                       else resolve_device(device))
        self.microbatch = int(cfg.get("microbatch", 1)) if self.takes_microbatch else 1
        self.save_path = cfg.get("save_path", "exp/default")
        os.makedirs(self.save_path, exist_ok=True)
        # one logger per run directory, so that each run has its train.log
        self.logger = get_root_logger(
            os.path.join(self.save_path, "train.log"),
            name=f"cdsegnet_torch.train:{os.path.abspath(self.save_path)}",
            rank=self.rank)
        self.logger.info(f"Save path: {self.save_path}")
        self.storage = EventStorage(self.save_path if self.rank == 0 else None)
        self.comm_info: Dict[str, Any] = {}
        self.epoch = 0
        self.start_epoch = 0
        self.step_in_epoch = 0
        self.max_epoch = cfg.eval_epoch if "eval_epoch" in cfg else cfg.epoch
        self.seed = cfg.get("seed") or 0
        self.depth = cfg.get("serialization_depth", 16)
        scenes_per_device = cfg.get("scenes_per_device", 2)
        if self.microbatch < 1 or scenes_per_device % self.microbatch:
            raise ValueError(f"microbatch={self.microbatch}: gradient accumulation needs "
                             f"scenes_per_device={scenes_per_device} to be a multiple")
        self.num_scenes = scenes_per_device // self.microbatch  # per micro bucket

        # ---- data ----
        bucket = cfg.get("bucket_num_points", 102400 * scenes_per_device)
        self.train_loader = self.build_train_loader(bucket)
        self.steps_per_epoch = len(self.train_loader)
        self.total_steps = self.steps_per_epoch * self.max_epoch
        self.val_loader = None
        val_condition = None
        if "val" in cfg.data:
            val_cfg = dict(cfg.data.val)
            val_condition = val_cfg.pop("condition", None)
            self.val_loader = EvalLoader(build_dataset(val_cfg),
                                         num_points=cfg.get("val_num_points", 1 << 19))

        # ---- model / optimizer ----
        self.model = build_model(dict(cfg.model), device=self.device,
                                 generator=torch.Generator().manual_seed(self.seed))
        n_params = sum(p.numel() for p in self.model.parameters())
        self.logger.info(f"Num params: {n_params / 1e6:.2f}M")
        self.criteria = build_model_criteria(dict(cfg.model))
        self.optimizer = build_optimizer(
            dict(cfg.optimizer), self.model,
            scheduler_cfg=dict(cfg.scheduler) if "scheduler" in cfg else None,
            total_steps=self.total_steps,
            param_dicts=[dict(g) for g in cfg.get("param_dicts", [])],
            clip_keywords=cfg.get("gredient_clip", []),  # reference key spelling
            device=self.device)
        self.ckpt_manager = CheckpointManager(os.path.join(self.save_path, "model"))
        self.train_step = make_train_step(self.model, self.criteria, self.optimizer,
                                          seed=self.seed, device=self.device,
                                          microbatch=self.microbatch)
        self.generators = self.train_step.generators  # the checkpoints carry them
        eval_kwargs = {}
        conditions = self.conditions
        if conditions and val_condition is not None:
            if val_condition not in conditions:
                raise ValueError(f"val condition {val_condition!r} not in model "
                                 f"conditions {conditions}")
            eval_kwargs["condition"] = conditions.index(val_condition)
        self.eval_step = make_eval_step(self.model, self.depth, 1, self.device,
                                        model_kwargs=eval_kwargs)

        # ---- hooks ----
        self.hooks = build_hooks(cfg.get("hooks", DEFAULT_HOOKS))
        for h in self.hooks:
            h.trainer = self

    @property
    def step(self) -> int:
        """Updates made so far (JAX's ``TrainState.step``)."""
        return self.optimizer.count

    @property
    def conditions(self) -> tuple:
        """The model config's dataset ``conditions`` (PPT), or ()."""
        return tuple(self.cfg.model.get("conditions", ()) or ())

    def build_train_loader(self, bucket: int) -> TrainLoader:
        cfg = self.cfg
        train_ds_cfg = dict(cfg.data.train)
        loop = max(cfg.epoch // self.max_epoch, 1) if "eval_epoch" in cfg else 1
        train_ds_cfg.setdefault("loop", loop)
        self.train_ds = build_dataset(train_ds_cfg)
        return TrainLoader(self.train_ds, num_devices=self.num_devices,
                           scenes_per_device=cfg.get("scenes_per_device", 2),
                           num_points=bucket, mix_prob=cfg.get("mix_prob", 0.0),
                           seed=self.seed, microbatch=self.microbatch, rank=self.rank)

    def batch_to_points(self, batch):
        """A loader batch as the step's input: one `PointBatch`, or one per
        micro bucket."""
        if self.microbatch == 1:
            return batch_to_point(batch, self.depth, self.num_scenes, self.device)
        return [batch_to_point({k: v[i] for k, v in batch.items()}, self.depth,
                               self.num_scenes, self.device)
                for i in range(self.microbatch)]

    def _select_train_step(self, ds_idx: Optional[int]):
        """The step of a batch from dataset ``ds_idx`` (None: one loader):
        the one step here; `MultiDatasetTrainer` keeps one per condition."""
        return self.train_step

    def _call_hooks(self, name: str):
        for h in self.hooks:
            getattr(h, name)()

    def _warn_on_overflow(self, metrics):
        """Loud warning when pyramid pooling dropped >0.1% of valid points
        at any level (the reference's ragged pooling never drops a point;
        static capacities are sized so real scans never overflow — see
        `PointTransformerV3.capacity_div`). Throttled to 5 warnings/run."""
        if getattr(self, "_overflow_warned", 0) >= 5:
            return
        valid = metrics.get("valid_points", 0.0)
        bad = {
            k: int(v) for k, v in metrics.items()
            if k.startswith("dropped_l") and v > max(1.0, valid / 1000.0)
        }
        if bad:
            self._overflow_warned = getattr(self, "_overflow_warned", 0) + 1
            self.logger.warning(
                f"pyramid capacity overflow: {bad} of {int(valid)} valid "
                f"points dropped this step (>0.1%); coarse levels are "
                f"degraded and neighbor tables fell back to the sorted "
                f"build — raise capacity_div or the point bucket"
            )

    @staticmethod
    def _host_metrics(metrics: Dict[str, Any]) -> Dict[str, float]:
        """The step's metrics as floats, the device ones in one copy."""
        keys = [k for k, v in metrics.items() if isinstance(v, torch.Tensor)]
        out = {k: float(v) for k, v in metrics.items() if k not in keys}
        if keys:
            values = torch.stack([metrics[k].float() for k in keys]).tolist()
            out.update(zip(keys, values))
        return {k: out[k] for k in metrics}

    def train(self):
        self._call_hooks("before_train")
        self._overflow_warned = 0
        for self.epoch in range(self.start_epoch, self.max_epoch):
            self._call_hooks("before_epoch")
            for self.step_in_epoch, batch in enumerate(
                    self.train_loader.epoch(self.epoch)):
                ds_idx = batch.pop("_dataset_idx", None)
                self._call_hooks("before_step")
                points = self.batch_to_points(batch)
                step = self._select_train_step(ds_idx)
                self.comm_info["metrics"] = self._host_metrics(step(points))
                self._warn_on_overflow(self.comm_info["metrics"])
                self._call_hooks("after_step")
            self._call_hooks("after_epoch")
        self._call_hooks("after_train")
        self.storage.close()


@TRAINERS.register_module("MSCTrainer")
class MSCTrainer(Trainer):
    """MSC pretraining (JAX's `MSCTrainer`, reference recipe
    `configs/scannet/pretrain-msc-v1m1-*`): the loader collates two
    augmented views per scene (`ContrastiveViewsGenerator` ->
    `collate_pair_scenes`, with the reconstruction targets of
    ``cfg.pair_feat_keys``) and the step drives the model's InfoNCE and
    reconstruction loss. No microbatch; no evaluator (pretraining has no
    val split)."""

    takes_microbatch = False

    def __init__(self, cfg, device: Optional[Union[str, torch.device]] = None):
        self.feat_keys = tuple(cfg.get("pair_feat_keys", ("color", "normal")))
        super().__init__(cfg, device)
        self.train_step = make_msc_train_step(self.model, self.criteria, self.optimizer,
                                              seed=self.seed, device=self.device)
        self.generators = self.train_step.generators

    def build_train_loader(self, bucket: int) -> TrainLoader:
        cfg = self.cfg
        train_ds_cfg = dict(cfg.data.train)
        train_ds_cfg.setdefault("loop", 1)
        self.train_ds = build_dataset(train_ds_cfg)
        return TrainLoader(self.train_ds, num_devices=self.num_devices,
                           scenes_per_device=cfg.get("scenes_per_device", 2),
                           num_points=bucket, seed=self.seed,
                           pair_feat_keys=self.feat_keys, rank=self.rank)

    def batch_to_points(self, batch):
        return msc_inputs(batch, self.depth, self.num_scenes, self.device, self.feat_keys)


@TRAINERS.register_module("MultiDatasetTrainer")
class MultiDatasetTrainer(Trainer):
    """Round-robin multi-dataset training (JAX's `MultiDatasetTrainer`,
    reference `train.py:355-372` and `datasets/dataloader.py:23-112`; PPT).

    ``cfg.data.train`` is a ``ConcatDataset`` config; each sub-dataset's
    ``loop`` is its round-robin ratio and its ``condition`` names the
    model's condition its batches train (unnamed: its position). The
    concat's ``loop`` (or the ``eval_epoch`` passes) applies to the main,
    first dataset, which governs the epoch's length."""

    def build_train_loader(self, bucket: int) -> MultiDatasetLoader:
        cfg = self.cfg
        train_cfg = dict(cfg.data.train)
        if train_cfg.get("type") != "ConcatDataset":
            raise ValueError("MultiDatasetTrainer expects cfg.data.train of type "
                             "ConcatDataset")
        concat_loop = int(train_cfg.get("loop", max(cfg.epoch // self.max_epoch, 1)
                                        if "eval_epoch" in cfg else 1))
        loaders, ratios = [], []
        self.train_ds, self.ds_conditions = [], []
        self.cond_steps = {}  # condition -> its step, built at its first batch
        for k, sub in enumerate(train_cfg["datasets"]):
            sub = dict(sub)
            ratios.append(int(sub.pop("loop", 1)))
            self.ds_conditions.append(sub.pop("condition", None))
            sub["loop"] = concat_loop if k == 0 else 1
            ds = build_dataset(sub)
            self.train_ds.append(ds)
            loaders.append(TrainLoader(ds, num_devices=self.num_devices,
                                       scenes_per_device=cfg.get("scenes_per_device", 2),
                                       num_points=bucket, mix_prob=cfg.get("mix_prob", 0.0),
                                       seed=self.seed, microbatch=self.microbatch,
                                       rank=self.rank))
        return MultiDatasetLoader(loaders, ratios)

    def condition_of(self, ds_idx: int) -> int:
        """The model condition of sub-dataset ``ds_idx``."""
        name = self.ds_conditions[ds_idx]
        if name is None:
            return ds_idx
        if name not in self.conditions:
            raise ValueError(f"sub-dataset {ds_idx} condition {name!r} not in model "
                             f"conditions {self.conditions}")
        return self.conditions.index(name)

    def _select_train_step(self, ds_idx: Optional[int]):
        if ds_idx is None or not self.conditions:
            return self.train_step
        cond = self.condition_of(ds_idx)
        if cond not in self.cond_steps:
            self.cond_steps[cond] = make_train_step(
                self.model, self.criteria, self.optimizer, device=self.device,
                microbatch=self.microbatch, model_kwargs=dict(condition=cond),
                generators=self.generators)
        return self.cond_steps[cond]
