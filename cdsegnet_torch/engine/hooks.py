"""Hook system and the default hooks of the trainer.

Port of `cdsegnet_tpu/engine/hooks.py` (reference
`pointcept/engines/hooks/{default,builder,misc,evaluator}.py`). The default
stack (`configs/_base_/default_runtime.py`): CheckpointLoader,
IterationTimer, InformationWriter, SemSegEvaluator, CheckpointSaver; a
config may add PreciseEvaluator, or name ClsEvaluator
(`configs/modelnet40/cls_ptv2.py`) or InsSegEvaluator
(`configs/scannet/insseg_pointgroup.py`) in place of the SemSeg one. A hook reads and writes the
trainer it is bound to (``hook.trainer``): its model, optimizer,
generators, checkpoint manager, storage, logger and ``comm_info``. In a process group of several
ranks (`parallel.dist`) every hook runs on every rank: the evaluator splits
the val scenes over the ranks and sums their histograms, the information
writer and the files act on rank 0, and the checkpoint loader reads on
every rank. The profiling hook `RuntimeProfiler` lives in
`engine/profiling.py`, which registers it here when this module is
imported.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from cdsegnet_torch.engine import insseg_eval as ie
from cdsegnet_torch.engine.checkpoint import snapshot
from cdsegnet_torch.engine.state import batch_to_point, rank_seed
from cdsegnet_torch.engine.test import NoiseFn, SemSegTester
from cdsegnet_torch.ops.pointops import knn_remap_labels
from cdsegnet_torch.parallel import dist
from cdsegnet_torch.utils.misc import AverageMeter, intersection_and_union_torch
from cdsegnet_torch.utils.registry import Registry

HOOKS = Registry("hooks")


class HookBase:
    trainer = None  # bound by the trainer

    def before_train(self):
        pass

    def before_epoch(self):
        pass

    def before_step(self):
        pass

    def after_step(self):
        pass

    def after_epoch(self):
        pass

    def after_train(self):
        pass


def build_hooks(cfgs) -> list:
    return [HOOKS.build(dict(c)) for c in (cfgs or [])]


@HOOKS.register_module()
class CheckpointLoader(HookBase):
    """Resume the whole training state from `model_last` when ``resume`` is
    set and it exists: the model, the optimizer's moments and count, and the
    step's generators (each rank its own); or load the model alone
    (parameters and running statistics) from the checkpoint ``weight``
    names (reference `hooks/misc.py:207-249`), such as one that
    `convert_jax_checkpoint.py` wrote from a JAX run. Every rank reads."""

    def __init__(self, keywords="", replacement=None):
        self.keywords = keywords
        self.replacement = replacement

    def before_train(self):
        tr = self.trainer
        if tr.cfg.get("resume", False) and tr.ckpt_manager.has("model_last"):
            tr.ckpt_manager.restore(tr.model, "model_last", optimizer=tr.optimizer,
                                    generators=tr.generators)
            tr.start_epoch = tr.step // max(tr.steps_per_epoch, 1)
            tr.logger.info(f"Resumed from checkpoint at step {tr.step} "
                           f"(epoch {tr.start_epoch})")
        elif tr.cfg.get("weight"):
            state = tr.ckpt_manager.restore_raw(tr.cfg.weight)
            if state is not None:
                tr.model.load_state_dict(state["model"])
                tr.logger.info(f"Loaded weights from {tr.cfg.weight}")


@HOOKS.register_module()
class IterationTimer(HookBase):
    """Wall-clock data/batch timing + ETA (reference `hooks/misc.py:32-75`).
    ``data`` is the wait for the loader's next batch; ``batch`` the whole
    step, ending in the host copy of its metrics."""

    def __init__(self, warmup_iter: int = 2):
        self.warmup = warmup_iter
        self.data_m = AverageMeter()
        self.batch_m = AverageMeter()

    def before_epoch(self):
        self._t = time.perf_counter()

    def before_step(self):
        self.data_m.update(time.perf_counter() - self._t)

    def after_step(self):
        now = time.perf_counter()
        self.batch_m.update(now - self._t)
        self._t = now
        tr = self.trainer
        remain = tr.total_steps - tr.step
        tr.comm_info["iter_info"] = (
            f"data {self.data_m.val:.3f}s batch {self.batch_m.val:.3f}s "
            f"eta {self.batch_m.avg * remain / 3600:.1f}h"
        )


@HOOKS.register_module()
class InformationWriter(HookBase):
    """Per-iteration log line + metric file (reference `hooks/misc.py:78-143`).
    The metrics are host floats already (one copy per step, `Trainer`)."""

    def __init__(self, log_interval: int = 10):
        self.log_interval = log_interval

    def after_step(self):
        if not dist.is_main():
            return
        tr = self.trainer
        step = tr.step
        metrics = tr.comm_info.get("metrics", {})
        for k, v in metrics.items():
            tr.storage.put_scalar(k, float(v))
        if step % self.log_interval == 0:
            loss = float(metrics.get("loss", float("nan")))
            msg = (
                f"Train [{tr.epoch + 1}/{tr.max_epoch}]"
                f"[{tr.step_in_epoch + 1}/{tr.steps_per_epoch}] "
                f"loss {loss:.4f} " + tr.comm_info.get("iter_info", "")
            )
            tr.logger.info(msg)
            tr.storage.write(step)


@HOOKS.register_module()
class SemSegEvaluator(HookBase):
    """Validation mIoU after each ``interval`` epochs (reference
    `hooks/evaluator.py:106-209`): one whole-scene SSI per val scene (the
    trainer's `EvalLoader` bucket), the argmax and the intersection/union
    histograms on the device, one host copy at the end. The c-branch noise
    of scene i is drawn from a device generator seeded with ``seed +
    epoch``, or taken from ``noise_fn(i, bucket, c_in)``. A model without
    `CNFSegmentor.draw_ssi_noise` (an ablation segmentor) draws its own SSI
    start, from a generator seeded for scene i from ``(seed + epoch, i)``,
    so that its draws do not depend on which rank evaluates the scene.

    A val scene with ``origin_coord`` (and ``origin_segment``) is scored on
    its original points: each takes the prediction of its nearest
    grid-sampled point (`ops.pointops.knn_remap_labels`, reference
    `hooks/evaluator.py:132-141`).

    Over several ranks, rank ``i % world`` evaluates scene i, and the integer
    histograms are summed over the ranks: the result equals one rank's.
    Every rank runs every scene's val pipeline and draws every scene's
    noise in order, so that the data and noise streams stay those of one
    rank. ``histograms`` keeps the last summed (intersection, union,
    target)."""

    def __init__(self, interval: int = 1, noise_fn: Optional[NoiseFn] = None):
        self.interval = interval
        self.noise_fn = noise_fn
        self.histograms = None

    def after_epoch(self):
        tr = self.trainer
        if tr.val_loader is None or (tr.epoch + 1) % self.interval != 0:
            return
        num_classes = tr.cfg.data.num_classes
        world, rank = dist.world_size(), dist.rank()
        sums = torch.zeros((3, num_classes), dtype=torch.int64, device=tr.device)
        gen = torch.Generator(tr.device).manual_seed(tr.seed + tr.epoch)
        c_in = getattr(tr.model, "c_in_channels", None)
        draw_noise = getattr(tr.model, "draw_ssi_noise", None)
        dev = lambda x: torch.as_tensor(x, device=tr.device)
        for index, (batch, scene) in enumerate(tr.val_loader):
            mine = index % world == rank
            bucket, feat_dim = batch["feat"].shape
            noise = None
            if self.noise_fn is not None:
                if mine:
                    noise = torch.as_tensor(self.noise_fn(index, bucket, c_in or feat_dim),
                                            dtype=torch.float32, device=tr.device)
            elif draw_noise is not None:
                noise = draw_noise(bucket, feat_dim, gen, tr.device)
            if not mine:
                continue
            g = gen
            if draw_noise is None and self.noise_fn is None:
                g = torch.Generator(tr.device).manual_seed(
                    rank_seed(tr.seed + tr.epoch, index + 1))
            out = tr.eval_step(batch, generator=g, noise=noise)
            pred, seg, valid = (out["seg_logits"].argmax(-1), dev(batch["segment"]),
                                dev(batch["mask"]))
            if "origin_coord" in scene:
                n_real = int(batch["mask"].sum())
                pred = knn_remap_labels(dev(scene["origin_coord"]).float(),
                                        dev(batch["coord"][:n_real]), pred[:n_real])
                seg = dev(np.asarray(scene["origin_segment"]).reshape(-1))
                valid = torch.ones_like(seg, dtype=torch.bool)
            sums += torch.stack(intersection_and_union_torch(pred, seg, num_classes,
                                                             valid))
        dist.all_reduce_sum_(sums)
        self.histograms = sums.cpu().numpy()
        inter_sum, union_sum, target_sum = self.histograms.astype(np.float64)
        iou = inter_sum / np.maximum(union_sum, 1)
        acc = inter_sum / np.maximum(target_sum, 1)
        miou = float(iou.mean())
        names = tr.cfg.data.get("names", [str(i) for i in range(num_classes)])
        for n, v_iou, v_acc in zip(names, iou, acc):
            tr.logger.info(f"Class {n}: iou {v_iou:.4f} acc {v_acc:.4f}")
        tr.logger.info(
            f"Val result: mIoU {miou:.4f} mAcc {float(acc.mean()):.4f} "
            f"allAcc {inter_sum.sum() / max(target_sum.sum(), 1):.4f}"
        )
        tr.comm_info["current_metric_value"] = miou
        tr.comm_info["current_metric_name"] = "mIoU"
        tr.storage.put_scalar("val/mIoU", miou)


@HOOKS.register_module()
class ClsEvaluator(HookBase):
    """Shape-classification validation after each ``interval`` epochs
    (reference `hooks/evaluator.py::ClsEvaluator`): each val shape through
    the eval step in the `EvalLoader`'s bucket, the argmax of its
    ``cls_pred`` against its ``category`` (else its first label), the
    per-class intersection, prediction and target counts on the device and
    one host copy at the end; logs mIoU, mAcc and allAcc, and exports
    ``allAcc`` as the checkpoint metric. Over several ranks, rank ``i %
    world`` evaluates shape i and the counts are summed. ``histograms``
    keeps the last summed (intersection, prediction, target) counts."""

    def __init__(self, interval: int = 1):
        self.interval = interval
        self.histograms = None

    def after_epoch(self):
        tr = self.trainer
        if tr.val_loader is None or (tr.epoch + 1) % self.interval != 0:
            return
        num_classes = tr.cfg.data.num_classes
        world, rank = dist.world_size(), dist.rank()
        counts = torch.zeros((3, num_classes), dtype=torch.int64, device=tr.device)
        for index, (batch, scene) in enumerate(tr.val_loader):
            if index % world != rank:
                continue
            label = int(np.asarray(scene.get("category", scene["segment"][0])))
            if not 0 <= label < num_classes:
                continue
            pred = tr.eval_step(batch)["cls_pred"][0].argmax()
            counts[0, label] += (pred == label).long()
            counts[1].index_add_(0, pred[None], torch.ones_like(pred[None]))
            counts[2, label] += 1
        dist.all_reduce_sum_(counts)
        self.histograms = counts.cpu().numpy()
        inter, pred_hist, target = self.histograms.astype(np.float64)
        # union = prediction + target - intersection (reference
        # `pointcept/utils/misc.py:38-52`)
        iou = inter / np.maximum(pred_hist + target - inter, 1)
        acc = inter / np.maximum(target, 1)
        all_acc = float(inter.sum() / max(target.sum(), 1))
        tr.logger.info(f"Val result: mIoU {iou.mean():.4f} mAcc {acc.mean():.4f} "
                       f"allAcc {all_acc:.4f}")
        tr.comm_info["current_metric_value"] = all_acc
        tr.comm_info["current_metric_name"] = "allAcc"
        tr.storage.put_scalar("val/allAcc", all_acc)


@HOOKS.register_module()
class InsSegEvaluator(HookBase):
    """Instance-segmentation validation after each ``interval`` epochs
    (reference `hooks/evaluator.py:213-589`): each val scene through the
    model's eval forward, `PointGroup.cluster` on its argmax and offsets,
    proposal masks from the clusters, and the ScanNet-protocol mAP@[.5:.95],
    AP50 and AP25 of `engine.insseg_eval` on the host; AP50 is the
    checkpoint metric. Every rank evaluates every scene (the matching runs
    on the host and gives each rank the same records). ``records`` keeps
    the last epoch's per-scene association records, ``summary`` its
    `insseg_eval.summarize_ap`."""

    def __init__(self, interval: int = 1, segment_ignore_index=(-1, 0, 1),
                 instance_ignore_index: int = -1, min_region_size: int = 100,
                 cluster_min_points: int = 100):
        self.interval = interval
        self.segment_ignore_index = tuple(segment_ignore_index)
        self.instance_ignore_index = instance_ignore_index
        self.min_region_size = min_region_size
        self.cluster_min_points = cluster_min_points
        self.records = self.summary = None

    @torch.no_grad()
    def predict(self, batch):
        """One val scene's ``(logits, cluster ids, mask)`` as numpy."""
        tr = self.trainer
        model = tr.model.eval()
        point = batch_to_point(batch, tr.depth, 1, tr.device)
        out = model(point)
        clusters = model.cluster(point, out["n_pred"].argmax(-1), out["offset_pred"])
        return out["n_pred"].cpu().numpy(), clusters.cpu().numpy(), point.mask.cpu().numpy()

    def after_epoch(self):
        tr = self.trainer
        if tr.val_loader is None or (tr.epoch + 1) % self.interval != 0:
            return
        num_classes = tr.cfg.data.num_classes
        valid_classes = [c for c in range(num_classes)
                         if c not in self.segment_ignore_index]
        scenes = []
        for batch, _scene in tr.val_loader:
            if "instance" not in batch:
                tr.logger.warning("InsSegEvaluator: batch has no instance targets; skipping")
                return
            logits, clusters, mask = self.predict(batch)
            probs = np.exp(logits - logits.max(-1, keepdims=True))
            probs /= probs.sum(-1, keepdims=True)
            masks, classes, scores = ie.proposals_from_clusters(
                clusters, logits.argmax(-1), probs, mask,
                min_points=self.cluster_min_points)
            scenes.append(ie.associate_instances(
                masks, classes, scores, np.where(mask, batch["segment"], -1),
                np.where(mask, batch["instance"], -1), num_classes,
                self.segment_ignore_index, self.min_region_size))
        ap = ie.evaluate_matches(scenes, valid_classes,
                                 min_region_size=self.min_region_size)
        s = ie.summarize_ap(ap)
        self.records, self.summary = scenes, s
        names = tr.cfg.data.get("names", [str(i) for i in range(num_classes)])
        for li, c in enumerate(valid_classes):
            tr.logger.info(f"Class {names[c]}: AP {s['per_class_ap'][li]:.4f}")
        tr.logger.info(f"Val result: mAP {s['all_ap']:.4f} AP50 {s['all_ap_50']:.4f} "
                       f"AP25 {s['all_ap_25']:.4f}")
        tr.comm_info["current_metric_value"] = s["all_ap_50"]
        tr.comm_info["current_metric_name"] = "AP50"
        tr.storage.put_scalar("val/mAP", s["all_ap"])
        tr.storage.put_scalar("val/AP50", s["all_ap_50"])


@HOOKS.register_module()
class CheckpointSaver(HookBase):
    """Save last/best/periodic checkpoints (reference `hooks/misc.py:146-204`):
    the model, the step, the optimizer and every rank's generators. Every
    rank calls it; rank 0 writes."""

    def __init__(self, save_freq: Optional[int] = None):
        self.save_freq = save_freq

    def before_train(self):
        self.best = -float("inf")

    def after_epoch(self):
        tr = self.trainer
        metric = tr.comm_info.get("current_metric_value")
        is_best = metric is not None and metric > self.best
        if is_best:
            self.best = metric
            tr.logger.info(f"New best {tr.comm_info.get('current_metric_name')}: {metric:.4f}")
        thresh = tr.cfg.get("save_freq_threshold")
        save_snapshot = bool(
            self.save_freq and (tr.epoch + 1) % self.save_freq == 0
            and (thresh is None or tr.epoch + 1 >= thresh)
        )
        tr.ckpt_manager.save_epoch(
            snapshot(tr.model, tr.step, tr.optimizer, tr.generators),
            tr.epoch + 1, is_best, save_snapshot)


@HOOKS.register_module()
class PreciseEvaluator(HookBase):
    """Run the TTA tester after training, on `model_best` (or `model_last`
    with ``test_last``) loaded into the trained model (reference
    `hooks/misc.py:252-278`)."""

    def __init__(self, test_last: bool = False):
        self.test_last = test_last

    def after_train(self):
        tr = self.trainer
        if tr.cfg.get("test") is None:
            return
        name = "model_last" if self.test_last else "model_best"
        if tr.ckpt_manager.has(name):
            tr.ckpt_manager.restore(tr.model, name)
        self.tester = SemSegTester(tr.cfg, model=tr.model, device=tr.device)
        self.tester.test()


# the profiling hook imports this module: register it last
import cdsegnet_torch.engine.profiling  # noqa: E402,F401
