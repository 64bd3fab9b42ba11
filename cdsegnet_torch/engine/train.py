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

Not ported, each raising `NotImplementedError`: `MSCTrainer`,
`MultiDatasetTrainer` and a val ``condition`` (PPT).
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional, Union

import torch

from cdsegnet_torch.data.datasets import build_dataset
from cdsegnet_torch.data.loader import EvalLoader, TrainLoader
from cdsegnet_torch.engine.checkpoint import CheckpointManager
from cdsegnet_torch.engine.events import EventStorage
from cdsegnet_torch.engine.hooks import build_hooks
from cdsegnet_torch.engine.optimizer import build_optimizer
from cdsegnet_torch.engine.state import batch_to_point, make_eval_step, make_train_step
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
        self.microbatch = int(cfg.get("microbatch", 1))
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
        if "val" in cfg.data:
            val_cfg = dict(cfg.data.val)
            if val_cfg.pop("condition", None) is not None:
                raise NotImplementedError(
                    'a val condition (PPT) is not ported (ROADMAP Queue 1: "The '
                    'model zoo and the rest of the engine and data")')
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
        self.eval_step = make_eval_step(self.model, self.depth, 1, self.device)

        # ---- hooks ----
        self.hooks = build_hooks(cfg.get("hooks", DEFAULT_HOOKS))
        for h in self.hooks:
            h.trainer = self

    @property
    def step(self) -> int:
        """Updates made so far (JAX's ``TrainState.step``)."""
        return self.optimizer.count

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
                self._call_hooks("before_step")
                points = self.batch_to_points(batch)
                self.comm_info["metrics"] = self._host_metrics(self.train_step(points))
                self._warn_on_overflow(self.comm_info["metrics"])
                self._call_hooks("after_step")
            self._call_hooks("after_epoch")
        self._call_hooks("after_train")
        self.storage.close()


TRAINERS.register_unported(("MSCTrainer", "MultiDatasetTrainer"),
                           "The model zoo and the rest of the engine and data")
