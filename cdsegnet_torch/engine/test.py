"""Testers: TTA fragment-voting semantic-segmentation evaluation.

Port of `SemSegTester` in `cdsegnet_tpu/engine/test.py` (reference
`pointcept/engines/test.py:34-414`) on one device. Per scene, every
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

Not ported, each raising `NotImplementedError`: ``num_devices > 1``
(fragment-parallel inference), ``model_kwargs``
(models other than `CNFSegmentor` and `PlainSegmentor`), `ClsTester` and
`PartSegTester`.
"""

from __future__ import annotations

import os
from typing import Any, Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch

from cdsegnet_torch.data.collate import collate_scenes, pick_bucket
from cdsegnet_torch.data.datasets import build_dataset
from cdsegnet_torch.engine.state import batch_to_point
from cdsegnet_torch.models.builder import build_model
from cdsegnet_torch.models.segmentor import CNFSegmentor, PlainSegmentor, inference_ddim
from cdsegnet_torch.models.structure import PointBatch
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
    unless ``device`` names another (raises without one); builds
    ``cfg.model`` with seeded random weights when no ``model`` is given
    (`tools.test.load_state` loads a checkpoint)."""

    def __init__(self, cfg, model: Optional[torch.nn.Module] = None,
                 device: Optional[Union[str, torch.device]] = None,
                 verbose: bool = True):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.logger = get_root_logger(name="cdsegnet_torch.test")
        self.verbose = verbose
        self.inference_mode = cfg.get("inference_mode", "SSI")
        self.inference_step = cfg.get("inference_step", 1)
        if self.inference_mode not in ("SSI", "MSAI", "MSFI"):
            raise ValueError(f"inference_mode={self.inference_mode!r}: "
                             "'SSI', 'MSAI' or 'MSFI'")
        if (cfg.get("num_devices") or 1) > 1:
            raise NotImplementedError(
                "num_devices > 1: fragment-parallel inference over several "
                'GPUs is not ported (ROADMAP Queue 1: "Microbatches and more '
                'than one device")')
        if cfg.get("model_kwargs"):
            raise NotImplementedError(
                "model_kwargs: models other than CNFSegmentor and "
                'PlainSegmentor are not ported (ROADMAP Queue 1: "The model zoo '
                'and the rest of the engine and data")')
        self.model = (model if model is not None
                      else build_model(dict(cfg.model), device=self.device)).eval()
        if not isinstance(self.model, (CNFSegmentor, PlainSegmentor)):
            raise NotImplementedError(
                f"{type(self.model).__name__}: only CNFSegmentor and "
                'PlainSegmentor are ported (ROADMAP Queue 1: "The model zoo and '
                'the rest of the engine and data")')
        if self.inference_mode != "SSI" and not isinstance(self.model, CNFSegmentor):
            raise ValueError(f"inference_mode={self.inference_mode!r} needs a "
                             "CNFSegmentor (DefaultSegmentorV2)")
        self.depth = cfg.get("serialization_depth", 16)
        self.buckets = tuple(cfg.get("test_buckets", DEFAULT_BUCKETS))
        self.noise_level = cfg.get("noise_level", None)
        self.save_path = cfg.get("save_path", "exp/default")
        self.seed = cfg.get("seed") or 0
        self.generator = torch.Generator(self.device).manual_seed(self.seed)

    def _prepare_fragment(self, frag: Dict, index: int, noise_fn: Optional[NoiseFn],
                          feat_noise_fn: Optional[FeatNoiseFn] = None
                          ) -> Tuple[int, PointBatch, torch.Tensor]:
        """Collate one fragment into its bucket on the device, perturb its
        features when ``noise_level`` is set, and draw its c-branch noise;
        ``feat_noise_fn`` and ``noise_fn`` replace the two draws."""
        n_frag = frag["coord"].shape[0]
        bucket = pick_bucket(n_frag, self.buckets)
        batch = collate_scenes([frag], bucket, 1)
        if self.noise_level is not None:
            # robustness protocol: gaussian-perturbed features
            feat = torch.as_tensor(batch["feat"], device=self.device)
            if feat_noise_fn is None:
                draw = torch.randn(feat.shape, generator=self.generator,
                                   device=self.device)
            else:
                draw = torch.as_tensor(feat_noise_fn(index, tuple(feat.shape)),
                                       dtype=torch.float32, device=self.device)
                if draw.shape != feat.shape:
                    raise ValueError(f"feat_noise_fn gave shape {tuple(draw.shape)}, "
                                     f"expected {tuple(feat.shape)}")
            batch["feat"] = feat + self.noise_level * draw
        point = batch_to_point(batch, self.depth, 1, self.device)
        c_in = getattr(self.model, "c_in_channels", batch["feat"].shape[-1])
        if noise_fn is None:
            noise = torch.randn((bucket, c_in), generator=self.generator,
                                dtype=torch.float32, device=self.device)
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
        ``noise`` in the MSAI and MSFI modes."""
        geometry = self.model.backbone.precompute_geometry(point)
        if self.inference_mode != "SSI":
            return inference_ddim(self.model, point, step=self.inference_step,
                                  mode="avg" if self.inference_mode == "MSAI" else "final",
                                  noise=noise, geometry=geometry)
        if isinstance(self.model, CNFSegmentor):
            return self.model.inference(point, noise=noise,
                                        geometry=geometry)["seg_logits"]
        return self.model(point, geometry=geometry)["n_pred"]

    def predict_fragment(self, frag: Dict, index: int,
                         noise_fn: Optional[NoiseFn] = None,
                         feat_noise_fn: Optional[FeatNoiseFn] = None) -> torch.Tensor:
        """Softmax probabilities ``(n_frag, num_classes)``, f32 on the
        device, of fragment number ``index``."""
        n_frag, point, noise = self._prepare_fragment(frag, index, noise_fn,
                                                      feat_noise_fn)
        logits = self.forward_fragment(point, noise)
        return torch.softmax(logits[:n_frag].float(), dim=-1)

    def predict_scene(self, scene: Dict, first_index: int = 0,
                      noise_fn: Optional[NoiseFn] = None,
                      feat_noise_fn: Optional[FeatNoiseFn] = None) -> np.ndarray:
        """The voted prediction of every raw point of ``scene`` (a test-mode
        dataset item), its fragments numbered from ``first_index``."""
        votes = torch.zeros((scene["segment"].size, self.cfg.data.num_classes),
                            dtype=torch.float32, device=self.device)
        for i, frag in enumerate(scene["fragment_list"]):
            probs = self.predict_fragment(frag, first_index + i, noise_fn,
                                          feat_noise_fn)
            votes.index_add_(0, torch.as_tensor(frag["index"], device=self.device),
                             probs)
        return votes.argmax(-1).cpu().numpy()

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
        if cfg.get("submission", False):
            self.write_submission(ds, name, pred)

    def test(self, noise_fn: Optional[NoiseFn] = None,
             feat_noise_fn: Optional[FeatNoiseFn] = None) -> float:
        """Evaluate ``cfg.data.test``; returns the mIoU and sets ``records``
        (per scene) and ``result`` (``miou``, ``macc``, ``allacc``). A
        scene whose ``result/<name>_pred.npy`` exists is read from it and
        takes no forward."""
        cfg = self.cfg
        ds = build_dataset(dict(cfg.data.test))
        num_classes = cfg.data.num_classes
        save_dir = os.path.join(self.save_path, "result")
        os.makedirs(save_dir, exist_ok=True)
        self._inter_sum = np.zeros(num_classes)
        self._union_sum = np.zeros(num_classes)
        self._target_sum = np.zeros(num_classes)
        self._scene_done = 0
        self._scene_total = len(ds)
        self.generator.manual_seed(self.seed)
        np_rng = np.random.default_rng(self.seed)
        self.records = {}
        index = 0
        for idx in range(len(ds)):
            scene = ds.get(idx, np_rng)
            name = scene["name"]
            segment = scene["segment"]
            cache = os.path.join(save_dir, f"{name}_pred.npy")
            if os.path.isfile(cache):
                self._finalize_scene(ds, name, np.load(cache), segment)
                continue
            pred = self.predict_scene(scene, index, noise_fn, feat_noise_fn)
            index += len(scene["fragment_list"])
            np.save(cache, pred)
            self._finalize_scene(ds, name, pred, segment)
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


TESTERS.register_unported(("ClsTester", "PartSegTester"),
                          "The model zoo and the rest of the engine and data")
