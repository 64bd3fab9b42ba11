"""Testers: TTA fragment-voting semantic-segmentation evaluation.

Port of `SemSegTester` in `cdsegnet_tpu/engine/test.py` (reference
`pointcept/engines/test.py:34-414`). Per scene, every
test-time augmentation is grid-sampled into fragments; each fragment is
padded into the smallest static bucket that holds it (`DEFAULT_BUCKETS`, as
in JAX: the bucket sets the pyramid's capacities), gets its geometry
pyramid and one SSI forward (attention through the CUDA kernel on a GPU),
or with ``inference_mode`` "MSAI" or "MSFI" the DDIM loop of
``inference_step`` steps over that one pyramid
(`models.segmentor.inference_ddim`), and its softmax votes are added into
the scene's full-resolution vote buffer on the device, in f32 with
`index_add_`. The argmax runs on the device and is copied to the host once
per scene. Records, mIoU against the full-resolution labels, the per-scene
``_pred.npy`` cache and the benchmark submission files follow the JAX
tester.

Noise: the c-branch input of fragment i (counted from 0 over one `test`
call) is drawn with shape ``(bucket, c_in)`` from one generator on the
device, seeded from ``cfg.seed``, as JAX draws it per fragment; the
``noise_level`` robustness perturbation of the features draws from the same
generator, before the c-branch noise. The DDIM modes start from that same
draw, as JAX draws their initial c state from the same key and shape.
``noise_fn(i, bucket, c_in)`` replaces the c-branch draw and
``feat_noise_fn(i, shape)`` the perturbation's (tests feed JAX's draws
through them).

Fragment-parallel inference, as JAX's tester runs it over its mesh: in a
process group (`parallel.dist`; `tools/test.py --num-gpus` or ``torchrun``
builds it) every rank runs every scene's test pipeline with the shared
numpy generator (its draws depend on each scene's points) and draws every
fragment's noise in order, and rank ``k % world`` forwards fragment k. The
probabilities of each group of ``world`` fragments go from their ranks to
every rank, which adds them into the votes in fragment order: preds and
records equal one rank's exactly. Rank 0 writes the preds, the cache and
the submission files. Every mode is grouped so: a DDIM fragment draws
nothing past its initial state, so MSAI and MSFI split over the ranks as
SSI does (JAX runs them on one device).

Models other than `CNFSegmentor` go through their plain forward in eval
mode, with ``cfg.model_kwargs`` (PPT's ``condition``), and give its
``seg_logits``, else ``n_pred``, as JAX's tester sends them; PPT's dual
branch takes the fragment's c-branch noise, as SSI does. For an ablation
segmentor (`models.ablation_segmentors`) that is its
training forward in eval mode: it draws a timestep and its noise and reads
the fragment's labels. Its draws come from a generator seeded for each
fragment from ``(cfg.seed, fragment index)``, so that they do not depend on
which rank forwards the fragment.

The shape tasks: `ClsTester` runs one forward per shape of a
`DefaultClassifier` in the smallest bucket that holds it (allAcc, mAcc);
`PartSegTester` votes fragments as `SemSegTester` does and scores each
shape by the IoU of its category's parts (instance and category mIoU). Both
run on one process, as JAX runs them on one device.

Not ported, raising `NotImplementedError`: the shape testers on more than
one rank.
"""

from __future__ import annotations

import os
from typing import Any, Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch

from cdsegnet_torch.data.collate import collate_scenes, pick_bucket
from cdsegnet_torch.data.datasets import build_dataset
from cdsegnet_torch.engine.state import batch_to_point, rank_seed
from cdsegnet_torch.models.builder import build_model
from cdsegnet_torch.models.segmentor import CNFSegmentor, inference_ddim
from cdsegnet_torch.models.structure import PointBatch
from cdsegnet_torch.parallel import dist
from cdsegnet_torch.utils import tracing
from cdsegnet_torch.utils.device import resolve_device
from cdsegnet_torch.utils.logger import get_root_logger
from cdsegnet_torch.utils.misc import intersection_and_union
from cdsegnet_torch.utils.registry import Registry

TESTERS = Registry("testers")

DEFAULT_BUCKETS = tuple(1024 * (1 << i) for i in range(4, 11))  # 16k..1M

NoiseFn = Callable[[int, int, int], Any]
FeatNoiseFn = Callable[[int, Tuple[int, ...]], Any]


@TESTERS.register_module("SemSegTester")
class SemSegTester:
    """``SemSegTester(cfg, model=None, device=None)``: runs on the GPU
    (a rank of a process group on ``cuda:<local_rank>``) unless ``device``
    names another (raises without one); builds ``cfg.model`` with seeded
    random weights when no ``model`` is given (`tools.test.load_state`
    loads a checkpoint). ``num_devices`` > 1 needs a process group of that
    size."""

    def __init__(self, cfg, model: Optional[torch.nn.Module] = None,
                 device: Optional[Union[str, torch.device]] = None,
                 verbose: bool = True):
        self.cfg = cfg
        num_devices = cfg.get("num_devices") or dist.world_size()
        if num_devices != dist.world_size():
            if not dist.is_initialized():
                raise RuntimeError(
                    f"num_devices={num_devices}: testing on more than one GPU needs a "
                    "process group (tools/test.py --num-gpus, or torchrun)")
            raise ValueError(f"num_devices={num_devices} in a process group of "
                             f"{dist.world_size()}")
        self.device = (dist.rank_device(device) if dist.is_initialized()
                       else resolve_device(device))
        self.logger = get_root_logger(name="cdsegnet_torch.test", rank=dist.rank())
        self.verbose = verbose
        self.inference_mode = cfg.get("inference_mode", "SSI")
        self.inference_step = cfg.get("inference_step", 1)
        if self.inference_mode not in ("SSI", "MSAI", "MSFI"):
            raise ValueError(f"inference_mode={self.inference_mode!r}: "
                             "'SSI', 'MSAI' or 'MSFI'")
        self.model_kwargs = dict(cfg.get("model_kwargs", {}) or {})
        self.model = (model if model is not None
                      else build_model(dict(cfg.model), device=self.device)).eval()
        if self.inference_mode != "SSI" and not isinstance(self.model, CNFSegmentor):
            raise ValueError(f"inference_mode={self.inference_mode!r} needs a "
                             "CNFSegmentor (DefaultSegmentorV2)")
        self.depth = cfg.get("serialization_depth", 16)
        self.buckets = tuple(cfg.get("test_buckets", DEFAULT_BUCKETS))
        self.noise_level = cfg.get("noise_level", None)
        self.save_path = cfg.get("save_path", "exp/default")
        self.seed = cfg.get("seed") or 0
        self.generator = torch.Generator(self.device).manual_seed(self.seed)
        # the draws of a plain forward that draws (the ablation segmentors)
        self.fragment_generator = torch.Generator(self.device)

    def _prepare_fragment(self, frag: Dict, index: int, noise_fn: Optional[NoiseFn],
                          feat_noise_fn: Optional[FeatNoiseFn] = None,
                          collate: bool = True
                          ) -> Tuple[int, Optional[PointBatch], torch.Tensor]:
        """Collate one fragment into its bucket on the device, perturb its
        features when ``noise_level`` is set, and draw its c-branch noise;
        ``feat_noise_fn`` and ``noise_fn`` replace the two draws. Without
        ``collate`` only the draws are made (another rank forwards it) and
        the point is None."""
        n_frag = frag["coord"].shape[0]
        bucket = pick_bucket(n_frag, self.buckets)
        feat_shape = (bucket, frag["feat"].shape[-1])
        batch = collate_scenes([frag], bucket, 1) if collate else None
        if self.noise_level is not None:
            # robustness protocol: gaussian-perturbed features
            if feat_noise_fn is None:
                draw = torch.randn(feat_shape, generator=self.generator,
                                   device=self.device)
            elif collate:
                draw = torch.as_tensor(feat_noise_fn(index, feat_shape),
                                       dtype=torch.float32, device=self.device)
                if tuple(draw.shape) != feat_shape:
                    raise ValueError(f"feat_noise_fn gave shape {tuple(draw.shape)}, "
                                     f"expected {feat_shape}")
            if collate:
                batch["feat"] = (torch.as_tensor(batch["feat"], device=self.device)
                                 + self.noise_level * draw)
        point = batch_to_point(batch, self.depth, 1, self.device) if collate else None
        if collate:
            self.fragment_generator.manual_seed(rank_seed(self.seed, index + 1))
        c_in = getattr(self.model, "c_in_channels", feat_shape[1])
        if noise_fn is None:
            noise = torch.randn((bucket, c_in), generator=self.generator,
                                dtype=torch.float32, device=self.device)
        elif not collate:
            noise = None
        else:
            noise = torch.as_tensor(noise_fn(index, bucket, c_in),
                                    dtype=torch.float32, device=self.device)
            if tuple(noise.shape) != (bucket, c_in):
                raise ValueError(f"noise_fn gave shape {tuple(noise.shape)}, "
                                 f"expected {(bucket, c_in)}")
        return n_frag, point, noise

    @torch.no_grad()
    def forward_fragment(self, point: PointBatch, noise: torch.Tensor) -> torch.Tensor:
        """Logits ``(bucket, num_classes)`` of one padded fragment: its
        geometry pyramid, then one SSI forward, or the DDIM loop from
        ``noise`` in the MSAI and MSFI modes; another model's plain forward
        in eval mode (its draws from ``fragment_generator``)."""
        geometry = self.model.backbone.precompute_geometry(point)
        if self.inference_mode != "SSI":
            return inference_ddim(self.model, point, step=self.inference_step,
                                  mode="avg" if self.inference_mode == "MSAI" else "final",
                                  noise=noise, geometry=geometry)
        if isinstance(self.model, CNFSegmentor):
            return self.model.inference(point, noise=noise,
                                        geometry=geometry)["seg_logits"]
        kwargs = dict(self.model_kwargs)
        if hasattr(self.model, "draw_ssi_noise"):  # PPT's dual branch
            kwargs["noise"] = noise
        out = self.model(point, geometry=geometry,
                         generators=dict(diffusion=self.fragment_generator), **kwargs)
        return out["seg_logits"] if "seg_logits" in out else out["n_pred"]

    def predict_fragment(self, frag: Dict, index: int,
                         noise_fn: Optional[NoiseFn] = None,
                         feat_noise_fn: Optional[FeatNoiseFn] = None) -> torch.Tensor:
        """Softmax probabilities ``(n_frag, num_classes)``, f32 on the
        device, of fragment number ``index``."""
        with tracing.span("infer.request"):
            with tracing.span("infer.prepare"):
                n_frag, point, noise = self._prepare_fragment(frag, index, noise_fn,
                                                              feat_noise_fn)
            with tracing.span("infer.forward"):
                logits = self.forward_fragment(point, noise)
                return torch.softmax(logits[:n_frag].float(), dim=-1)

    def _finalize_scene(self, ds, name: str, pred: np.ndarray,
                        segment: np.ndarray):
        """Meters + per-scene record + log + submission for one finished
        scene (reference `test.py:278-299,372-414`)."""
        cfg = self.cfg
        i, u, t = intersection_and_union(
            pred, segment, cfg.data.num_classes, cfg.get("ignore_index", -1)
        )
        self._inter_sum += i
        self._union_sum += u
        self._target_sum += t
        self.records[name] = dict(intersection=i, union=u, target=t)
        self._scene_done += 1
        if self.verbose:
            miou_scene = float(np.mean(i / np.maximum(u, 1)))
            self.logger.info(
                f"Test [{self._scene_done}/{self._scene_total}] {name}: "
                f"scene mIoU {miou_scene:.4f}"
            )
        if cfg.get("submission", False) and dist.is_main():
            self.write_submission(ds, name, pred)

    def test(self, noise_fn: Optional[NoiseFn] = None,
             feat_noise_fn: Optional[FeatNoiseFn] = None) -> float:
        """Evaluate ``cfg.data.test``; returns the mIoU and sets ``records``
        (per scene) and ``result`` (``miou``, ``macc``, ``allacc``). A
        scene whose ``result/<name>_pred.npy`` exists is read from it and
        takes no forward. In a process group the fragments are forwarded
        over the ranks, and every rank ends with the same records and
        result."""
        cfg = self.cfg
        ds = build_dataset(dict(cfg.data.test))
        num_classes = cfg.data.num_classes
        save_dir = os.path.join(self.save_path, "result")
        if dist.is_main():
            os.makedirs(save_dir, exist_ok=True)
        dist.barrier()
        self._inter_sum = np.zeros(num_classes)
        self._union_sum = np.zeros(num_classes)
        self._target_sum = np.zeros(num_classes)
        self._scene_done = 0
        self._scene_total = len(ds)
        self.generator.manual_seed(self.seed)
        self.records = {}
        self._test_scenes(ds, save_dir, noise_fn, feat_noise_fn)
        inter_sum, union_sum, target_sum = (
            self._inter_sum, self._union_sum, self._target_sum
        )
        iou = inter_sum / np.maximum(union_sum, 1)
        acc = inter_sum / np.maximum(target_sum, 1)
        self.result = dict(miou=float(iou.mean()), macc=float(acc.mean()),
                           allacc=float(inter_sum.sum() / max(target_sum.sum(), 1)))
        names = cfg.data.get("names", [str(i) for i in range(num_classes)])
        for n, v in zip(names, iou):
            self.logger.info(f"Class {n}: iou {v:.4f}")
        self.logger.info(
            f"Test result: mIoU {self.result['miou']:.4f} mAcc "
            f"{self.result['macc']:.4f} allAcc {self.result['allacc']:.4f}"
        )
        return self.result["miou"]

    def _test_scenes(self, ds, save_dir: str, noise_fn: Optional[NoiseFn],
                     feat_noise_fn: Optional[FeatNoiseFn]) -> None:
        """Every scene in turn, its fragments in order: fragment k is
        forwarded by rank ``k % world`` (every one on a single process);
        each group of ``world`` consecutive fragments is shared by every
        rank and voted in fragment order. Scenes finish in order."""
        world, rank = dist.world_size(), dist.rank()
        np_rng = np.random.default_rng(self.seed)
        group = []  # (scene entry, raw indices, probs or their row count)
        scenes = []  # scene entries in order: name, segment, votes, pending, pred
        index = 0
        for idx in range(len(ds)):
            scene = ds.get(idx, np_rng)
            name = scene["name"]
            cache = os.path.join(save_dir, f"{name}_pred.npy")
            entry = dict(name=name, segment=scene["segment"], pred=None, pending=0)
            scenes.append(entry)
            if dist.broadcast_object(os.path.isfile(cache) if rank == 0 else None):
                entry.update(pred=np.load(cache), cached=True)
                self._finish_scenes(ds, scenes, save_dir)
                continue
            entry["votes"] = torch.zeros((scene["segment"].size, self.cfg.data.num_classes),
                                         dtype=torch.float32, device=self.device)
            entry["pending"] = len(scene["fragment_list"])
            for frag in scene["fragment_list"]:
                if index % world == rank:
                    probs = self.predict_fragment(frag, index, noise_fn, feat_noise_fn)
                else:  # another rank forwards it: only its draws
                    probs, _, _ = self._prepare_fragment(frag, index, noise_fn,
                                                         feat_noise_fn, collate=False)
                group.append((entry, frag["index"], probs))
                index += 1
                if len(group) == world:
                    self._vote_group(group)
                    group = []
                    self._finish_scenes(ds, scenes, save_dir)
            self._finish_scenes(ds, scenes, save_dir)
        if group:
            self._vote_group(group)
            self._finish_scenes(ds, scenes, save_dir)
        assert not scenes, f"unfinished scenes: {[e['name'] for e in scenes]}"

    def _vote_group(self, group) -> None:
        """Share every fragment's probabilities of ``group`` from the rank
        that forwarded it (the j-th from rank j), and add them into their
        scenes' votes in fragment order."""
        num_classes = self.cfg.data.num_classes
        probs = [p.contiguous() if torch.is_tensor(p) else
                 torch.empty((p, num_classes), dtype=torch.float32, device=self.device)
                 for _, _, p in group]
        for j, p in enumerate(probs):
            dist.broadcast_(p, src=j)
        for (entry, raw_index, _), p in zip(group, probs):
            entry["votes"].index_add_(0, torch.as_tensor(raw_index, device=self.device), p)
            entry["pending"] -= 1

    def _finish_scenes(self, ds, scenes, save_dir: str) -> None:
        """Finalize the leading scenes whose fragments are all voted."""
        while scenes and (scenes[0]["pred"] is not None or scenes[0]["pending"] == 0):
            e = scenes.pop(0)
            if e["pred"] is None:
                e["pred"] = e.pop("votes").argmax(-1).cpu().numpy()
            if dist.is_main() and not e.get("cached"):
                np.save(os.path.join(save_dir, f"{e['name']}_pred.npy"), e["pred"])
            self._finalize_scene(ds, e["name"], e["pred"], e["segment"])

    def write_submission(self, ds, name: str, pred: np.ndarray):
        """Benchmark submission files (reference `test.py:329-370`).

        - ScanNet / ScanNet200: per-scene txt of raw class ids
          (`class2id[pred]`).
        - SemanticKITTI: ``sequences/<seq>/predictions/<frame>.label`` uint32
          files of `learning_map_inv`-remapped raw labels.
        - nuScenes: ``lidarseg/test/<token>_lidarseg.bin`` uint8 files of
          ``pred + 1`` (the lidarseg challenge's 1-based label space).
        """
        sub_dir = os.path.join(self.save_path, "submit")
        dataset_type = self.cfg.data.test.get("type", "")
        if dataset_type in ("ScanNetDataset", "ScanNet200Dataset"):
            os.makedirs(sub_dir, exist_ok=True)
            np.savetxt(
                os.path.join(sub_dir, f"{name}.txt"),
                ds.class2id[pred].reshape(-1, 1), fmt="%d",
            )
        elif dataset_type == "SemanticKITTIDataset":
            seq_name, frame_name = name.split("_")
            pred_dir = os.path.join(sub_dir, "sequences", seq_name, "predictions")
            os.makedirs(pred_dir, exist_ok=True)
            lut_keys = np.array(list(ds.learning_map_inv.keys()), np.int64)
            lut = np.zeros(int(lut_keys.max()) + 1, np.uint32)
            for k, v in ds.learning_map_inv.items():
                if k >= 0:
                    lut[k] = v
            lut[np.clip(pred, 0, len(lut) - 1)].astype(np.uint32).tofile(
                os.path.join(pred_dir, f"{frame_name}.label")
            )
        elif dataset_type == "NuScenesDataset":
            out_dir = os.path.join(sub_dir, "lidarseg", "test")
            os.makedirs(out_dir, exist_ok=True)
            (pred + 1).astype(np.uint8).tofile(
                os.path.join(out_dir, f"{name}_lidarseg.bin")
            )


def _one_rank(kind: str) -> None:
    if dist.world_size() > 1:
        raise NotImplementedError(
            f'{kind} on {dist.world_size()} ranks is not ported (ROADMAP Queue 1: '
            '"The shape testers on more than one rank")')


@TESTERS.register_module("ClsTester")
class ClsTester:
    """Shape-classification tester (reference `test.py:420-480`): each shape
    of ``cfg.data.test`` through its pipeline (one numpy generator seeded
    from ``cfg.seed``), padded into the smallest bucket of ``test_buckets``
    that holds it, one eval forward of the `DefaultClassifier`; the argmax
    of its ``cls_pred`` against its ``category`` (else its first label).
    ``test`` returns allAcc and sets ``records`` (per shape: label, pred and
    the softmax probabilities) and ``result`` (``allacc``, ``macc``)."""

    def __init__(self, cfg, model: Optional[torch.nn.Module] = None,
                 device: Optional[Union[str, torch.device]] = None, verbose: bool = True):
        _one_rank("ClsTester")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.logger = get_root_logger(name="cdsegnet_torch.test")
        self.verbose = verbose
        self.model = (model if model is not None
                      else build_model(dict(cfg.model), device=self.device)).eval()
        self.depth = cfg.get("serialization_depth", 12)
        self.buckets = tuple(cfg.get("test_buckets", DEFAULT_BUCKETS))
        self.seed = cfg.get("seed") or 0

    @torch.no_grad()
    def test(self) -> float:
        cfg = self.cfg
        ds = build_dataset(dict(cfg.data.test))
        num_classes = cfg.data.num_classes
        correct = np.zeros(num_classes)
        total = np.zeros(num_classes)
        rng = np.random.default_rng(self.seed)
        self.records = {}
        for idx in range(len(ds)):
            shape = ds.get(idx, rng)
            label = int(np.asarray(shape.get("category", shape["segment"][0])))
            bucket = pick_bucket(shape["coord"].shape[0], self.buckets)
            point = batch_to_point(collate_scenes([shape], bucket, 1), self.depth, 1,
                                   self.device)
            probs = torch.softmax(self.model(point)["cls_pred"][0].float(), -1).cpu().numpy()
            pred = int(probs.argmax())
            total[label] += 1
            correct[label] += int(pred == label)
            self.records[ds.get_data_name(idx)] = dict(label=label, pred=pred, probs=probs)
        seen = total > 0
        self.result = dict(allacc=float(correct.sum() / max(total.sum(), 1)),
                           macc=float(np.mean(correct[seen] / total[seen])))
        self.logger.info(f"Cls result: allAcc {self.result['allacc']:.4f} "
                         f"mAcc {self.result['macc']:.4f}")
        return self.result["allacc"]


@TESTERS.register_module("PartSegTester")
class PartSegTester(SemSegTester):
    """Part-segmentation tester (reference `test.py:483-591`): each shape's
    fragments voted as `SemSegTester` votes them (`predict_fragment`), then
    the IoU of each part of the shape's category (`category2part`; a part
    absent from both the labels and the prediction counts 1.0), averaged per
    shape. ``test`` returns the instance mIoU (mean over shapes) and sets
    ``records`` (per shape: category, part IoUs, shape IoU, pred and the
    number of points some fragment voted for) and
    ``result`` (``ins_miou``, ``cat_miou``: the mean over categories of
    their shapes' mean). A dataset without categories is tested as
    `SemSegTester` tests it."""

    def __init__(self, cfg, model: Optional[torch.nn.Module] = None,
                 device: Optional[Union[str, torch.device]] = None, verbose: bool = True):
        _one_rank("PartSegTester")
        super().__init__(cfg, model=model, device=device, verbose=verbose)

    def test(self, noise_fn: Optional[NoiseFn] = None,
             feat_noise_fn: Optional[FeatNoiseFn] = None) -> float:
        cfg = self.cfg
        ds = build_dataset(dict(cfg.data.test))
        categories = list(getattr(ds, "categories", []))
        category2part = dict(getattr(ds, "category2part", {}))
        if not categories:
            return super().test(noise_fn, feat_noise_fn)
        n_cat = len(categories)
        iou_category = np.zeros(n_cat)
        iou_count = np.zeros(n_cat)
        np_rng = np.random.default_rng(self.seed)
        self.generator.manual_seed(self.seed)
        self.records = {}
        index = 0
        for idx in range(len(ds)):
            scene = ds.get(idx, np_rng)
            segment = scene["segment"]
            votes = torch.zeros((segment.size, cfg.data.num_classes), dtype=torch.float32,
                                device=self.device)
            for frag in scene["fragment_list"]:
                probs = self.predict_fragment(frag, index, noise_fn, feat_noise_fn)
                votes.index_add_(0, torch.as_tensor(frag["index"], device=self.device),
                                 probs)
                index += 1
            pred = votes.argmax(-1).cpu().numpy()
            voted = int((votes.sum(-1) > 0).sum().item())
            cat_idx = int(scene["category"])
            parts = category2part[categories[cat_idx]]
            parts_iou = np.zeros(len(parts))
            for j, part in enumerate(parts):
                gt, pd = segment == part, pred == part
                if not gt.any() and not pd.any():
                    parts_iou[j] = 1.0
                else:
                    parts_iou[j] = (gt & pd).sum() / max((gt | pd).sum(), 1)
            iou_category[cat_idx] += parts_iou.mean()
            iou_count[cat_idx] += 1
            self.records[scene["name"]] = dict(category=cat_idx, parts_iou=parts_iou,
                                               iou=float(parts_iou.mean()), pred=pred,
                                               voted=voted)
            if self.verbose:
                self.logger.info(f"Test [{idx + 1}/{len(ds)}] {scene['name']} "
                                 f"({categories[cat_idx]}): shape IoU "
                                 f"{parts_iou.mean():.4f}")
        self.result = dict(
            ins_miou=float(iou_category.sum() / max(iou_count.sum(), 1e-10)),
            cat_miou=float(np.mean(iou_category / np.maximum(iou_count, 1e-10))))
        for i, name in enumerate(categories):
            self.logger.info(f"Category {name}: iou "
                             f"{iou_category[i] / max(iou_count[i], 1e-10):.4f} "
                             f"({int(iou_count[i])} shapes)")
        self.logger.info(f"PartSeg result: ins.mIoU {self.result['ins_miou']:.4f} "
                         f"cat.mIoU {self.result['cat_miou']:.4f}")
        return self.result["ins_miou"]
