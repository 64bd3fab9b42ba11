"""Host-side (numpy) data transforms.

Port of every transform of `cdsegnet_tpu/data/transforms.py` (reference
`pointcept/datasets/transform.py`), with the same two conventions:

- every transform takes ``(data_dict, rng)`` with an explicit
  `numpy.random.Generator`, so the whole pipeline is reproducible per sample
  and draws what the JAX package draws for the same seed;
- point-wise keys are subset generically via `take()`.

`GridSample` keeps the reference's voxel-hash semantics (FNV-1a; train: one
random point per voxel; test: every rotation of per-voxel picks as a
fragment list, `transform.py:796-933`). It hashes and picks with the numpy
versions of the JAX package's host library (`cdsegnet_tpu/data/native.py`);
the pick sorts stably, where the C library's `std::sort` may order equal
keys otherwise. The training augmentations of `configs/scannet/cdsegnet.py`
(dropout, jitter, elastic distortion, chromatic, sphere crop) draw from the
same generator calls, in the same order, as JAX's. `ElasticDistortion` needs
scipy and does nothing without it, as in the JAX package. `SphereCrop`'s
mode "all" covers a test fragment with crops of ``point_max`` points (the
tester's test-time ``crop``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

try:  # optional, as in the JAX package: without it ElasticDistortion is a no-op
    import scipy.interpolate
    import scipy.ndimage
    _HAVE_SCIPY = True
except Exception:  # pragma: no cover
    _HAVE_SCIPY = False

from cdsegnet_torch.utils.registry import Registry

TRANSFORMS = Registry("transforms")

POINT_KEYS = (
    "coord", "grid_coord", "origin_coord", "color", "normal", "strength",
    "segment", "instance", "instance_centroid", "displacement", "index",
)


def take(data: Dict, idx: np.ndarray) -> Dict:
    """Subset every point-wise key by ``idx``."""
    for k in POINT_KEYS:
        if k in data:
            data[k] = data[k][idx]
    return data


class Compose:
    def __init__(self, cfgs: Optional[Sequence[Dict]] = None):
        self.transforms = [TRANSFORMS.build(dict(c)) for c in (cfgs or [])]

    def __call__(self, data: Dict, rng: Optional[np.random.Generator] = None):
        rng = rng or np.random.default_rng()
        for t in self.transforms:
            data = t(data, rng)
        return data


@TRANSFORMS.register_module()
class Collect:
    """Assemble `feat` from feat_keys and keep only requested keys
    (reference `transform.py:27-50`; batching is the static-shape
    collator's)."""

    def __init__(self, keys=("coord", "grid_coord", "segment"),
                 feat_keys=("color", "normal")):
        self.keys = keys
        self.feat_keys = feat_keys

    def __call__(self, data, rng=None):
        out = {k: data[k] for k in self.keys if k in data}
        out["feat"] = np.concatenate(
            [np.atleast_2d(data[k].T).T for k in self.feat_keys], axis=-1
        ).astype(np.float32)
        return out


@TRANSFORMS.register_module()
class Copy:
    """``keys_dict`` maps a key to the new key that gets a copy of it; a
    value that is not a string is stored under its key as is."""

    def __init__(self, keys_dict=None):
        self.keys_dict = keys_dict or {}

    def __call__(self, data, rng=None):
        for k, v in self.keys_dict.items():
            if isinstance(v, str):
                data[v] = data[k].copy() if hasattr(data[k], "copy") else data[k]
            else:
                data[k] = v
        return data


@TRANSFORMS.register_module()
class NormalizeColor:
    def __call__(self, data, rng=None):
        if "color" in data:
            data["color"] = data["color"] / 127.5 - 1.0
        return data


@TRANSFORMS.register_module()
class NormalizeCoord:
    def __call__(self, data, rng=None):
        if "coord" in data:
            centroid = np.mean(data["coord"], axis=0)
            data["coord"] -= centroid
            m = np.max(np.sqrt(np.sum(data["coord"] ** 2, axis=1)))
            data["coord"] = data["coord"] / m
        return data


@TRANSFORMS.register_module()
class PositiveShift:
    def __call__(self, data, rng=None):
        if "coord" in data:
            data["coord"] -= data["coord"].min(axis=0)
        return data


@TRANSFORMS.register_module()
class CenterShift:
    def __init__(self, apply_z=True):
        self.apply_z = apply_z

    def __call__(self, data, rng=None):
        if "coord" in data:
            lo = data["coord"].min(axis=0)
            hi = data["coord"].max(axis=0)
            shift = np.array(
                [(lo[0] + hi[0]) / 2, (lo[1] + hi[1]) / 2,
                 lo[2] if self.apply_z else 0.0]
            )
            data["coord"] = data["coord"] - shift
        return data


@TRANSFORMS.register_module()
class RandomShift:
    def __init__(self, shift=((-0.2, 0.2), (-0.2, 0.2), (0, 0))):
        self.shift = shift

    def __call__(self, data, rng):
        if "coord" in data:
            s = np.array([rng.uniform(lo, hi) for lo, hi in self.shift])
            data["coord"] = data["coord"] + s
        return data


@TRANSFORMS.register_module()
class PointClip:
    def __init__(self, point_cloud_range=(-80, -80, -3, 80, 80, 1)):
        self.range = np.array(point_cloud_range, np.float32)

    def __call__(self, data, rng=None):
        if "coord" in data:
            data["coord"] = np.clip(data["coord"], self.range[:3], self.range[3:])
        return data


@TRANSFORMS.register_module()
class RandomDropout:
    def __init__(self, dropout_ratio=0.2, dropout_application_ratio=0.5):
        self.dropout_ratio = dropout_ratio
        self.dropout_application_ratio = dropout_application_ratio

    def __call__(self, data, rng):
        if rng.random() < self.dropout_application_ratio:
            n = len(data["coord"])
            idx = rng.choice(n, int(n * (1 - self.dropout_ratio)), replace=False)
            if "sampled_index" in data:
                idx = np.unique(np.append(idx, data["sampled_index"]))
                mask = np.zeros(len(data["segment"]), bool)
                mask[data["sampled_index"]] = True
                data["sampled_index"] = np.where(mask[idx])[0]
            take(data, idx)
        return data


def _rot_matrix(angle: float, axis: str) -> np.ndarray:
    c, s = np.cos(angle), np.sin(angle)
    if axis == "x":
        return np.array([[1, 0, 0], [0, c, -s], [0, s, c]])
    if axis == "y":
        return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
    if axis == "z":
        return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
    raise NotImplementedError(axis)


class _RotateBase:
    def _apply(self, data, angle, axis, center):
        rot = _rot_matrix(angle, axis)
        if "coord" in data:
            if center is None:
                lo, hi = data["coord"].min(0), data["coord"].max(0)
                center = (lo + hi) / 2
            data["coord"] = (data["coord"] - center) @ rot.T + center
        if "normal" in data:
            data["normal"] = data["normal"] @ rot.T
        return data


@TRANSFORMS.register_module()
class RandomRotate(_RotateBase):
    def __init__(self, angle=None, center=None, axis="z", always_apply=False, p=0.5):
        self.angle = [-1, 1] if angle is None else angle
        self.axis = axis
        self.p = 1.0 if always_apply else p
        self.center = center

    def __call__(self, data, rng):
        if rng.random() > self.p:
            return data
        angle = rng.uniform(self.angle[0], self.angle[1]) * np.pi
        return self._apply(data, angle, self.axis, self.center)


@TRANSFORMS.register_module()
class RandomRotateTargetAngle(_RotateBase):
    def __init__(self, angle=(1 / 2, 1, 3 / 2), center=None, axis="z",
                 always_apply=False, p=0.75):
        self.angle = angle
        self.axis = axis
        self.p = 1.0 if always_apply else p
        self.center = center

    def __call__(self, data, rng):
        if rng.random() > self.p:
            return data
        angle = rng.choice(self.angle) * np.pi
        return self._apply(data, angle, self.axis, self.center)


@TRANSFORMS.register_module()
class RandomScale:
    def __init__(self, scale=None, anisotropic=False):
        self.scale = scale or [0.95, 1.05]
        self.anisotropic = anisotropic

    def __call__(self, data, rng):
        if "coord" in data:
            s = rng.uniform(self.scale[0], self.scale[1],
                            3 if self.anisotropic else 1)
            data["coord"] = data["coord"] * s
        return data


@TRANSFORMS.register_module()
class RandomFlip:
    def __init__(self, p=0.5):
        self.p = p

    def __call__(self, data, rng):
        for axis in (0, 1):
            if rng.random() < self.p:
                if "coord" in data:
                    data["coord"][:, axis] = -data["coord"][:, axis]
                if "normal" in data:
                    data["normal"][:, axis] = -data["normal"][:, axis]
        return data


@TRANSFORMS.register_module()
class RandomJitter:
    def __init__(self, sigma=0.01, clip=0.05):
        assert clip > 0
        self.sigma = sigma
        self.clip = clip

    def __call__(self, data, rng):
        if "coord" in data:
            j = np.clip(self.sigma * rng.standard_normal(data["coord"].shape),
                        -self.clip, self.clip)
            data["coord"] = data["coord"] + j
        return data


@TRANSFORMS.register_module()
class ChromaticAutoContrast:
    def __init__(self, p=0.2, blend_factor=None):
        self.p = p
        self.blend_factor = blend_factor

    def __call__(self, data, rng):
        if "color" in data and rng.random() < self.p:
            lo = data["color"].min(0, keepdims=True)
            hi = data["color"].max(0, keepdims=True)
            scale = 255 / np.maximum(hi - lo, 1e-6)
            contrast = (data["color"][:, :3] - lo) * scale
            blend = self.blend_factor if self.blend_factor is not None else rng.random()
            data["color"][:, :3] = (1 - blend) * data["color"][:, :3] + blend * contrast
        return data


@TRANSFORMS.register_module()
class ChromaticTranslation:
    def __init__(self, p=0.95, ratio=0.05):
        self.p = p
        self.ratio = ratio

    def __call__(self, data, rng):
        if "color" in data and rng.random() < self.p:
            tr = (rng.random((1, 3)) - 0.5) * 255 * 2 * self.ratio
            data["color"][:, :3] = np.clip(tr + data["color"][:, :3], 0, 255)
        return data


@TRANSFORMS.register_module()
class ChromaticJitter:
    def __init__(self, p=0.95, std=0.005):
        self.p = p
        self.std = std

    def __call__(self, data, rng):
        if "color" in data and rng.random() < self.p:
            noise = rng.standard_normal((data["color"].shape[0], 3)) * self.std * 255
            data["color"][:, :3] = np.clip(noise + data["color"][:, :3], 0, 255)
        return data


@TRANSFORMS.register_module()
class RandomColorDrop:
    def __init__(self, p=0.2, color_augment=0.0):
        self.p = p
        self.color_augment = color_augment

    def __call__(self, data, rng):
        if "color" in data and rng.random() < self.p:
            data["color"] = data["color"] * self.color_augment
        return data


@TRANSFORMS.register_module()
class RandomColorGrayScale:
    def __init__(self, p=0.1):
        self.p = p

    def __call__(self, data, rng):
        if "color" in data and rng.random() < self.p:
            gray = data["color"][:, :3] @ np.array([0.299, 0.587, 0.114])
            data["color"][:, :3] = gray[:, None]
        return data


@TRANSFORMS.register_module()
class ElasticDistortion:
    def __init__(self, distortion_params=None):
        self.params = distortion_params or [[0.2, 0.4], [0.8, 1.6]]

    @staticmethod
    def _distort(coords, granularity, magnitude, rng):
        blur = [np.ones(s, np.float32) / 3 for s in
                ((3, 1, 1, 1), (1, 3, 1, 1), (1, 1, 3, 1))]
        cmin = coords.min(0)
        dim = ((coords - cmin).max(0) // granularity).astype(int) + 3
        noise = rng.standard_normal(size=(*dim, 3)).astype(np.float32)
        for _ in range(2):
            for b in blur:
                noise = scipy.ndimage.convolve(noise, b, mode="constant", cval=0)
        ax = [np.linspace(lo, hi, d) for lo, hi, d in
              zip(cmin - granularity, cmin + granularity * (dim - 2), dim)]
        interp = scipy.interpolate.RegularGridInterpolator(
            ax, noise, bounds_error=False, fill_value=0
        )
        return coords + interp(coords) * magnitude

    def __call__(self, data, rng):
        if "coord" in data and _HAVE_SCIPY and rng.random() < 0.95:
            for granularity, magnitude in self.params:
                data["coord"] = self._distort(
                    data["coord"], granularity, magnitude, rng
                )
        return data


def fnv_hash_vec(arr: np.ndarray) -> np.ndarray:
    """FNV64-1A voxel hash (reference `transform.py:920-933`)."""
    assert arr.ndim == 2
    arr = arr.astype(np.uint64, copy=True)
    h = np.uint64(14695981039346656037) * np.ones(arr.shape[0], np.uint64)
    for j in range(arr.shape[1]):
        h *= np.uint64(1099511628211)
        h = np.bitwise_xor(h, arr[:, j])
    return h


def ravel_hash_vec(arr: np.ndarray) -> np.ndarray:
    assert arr.ndim == 2
    arr = arr.copy()
    arr -= arr.min(0)
    arr = arr.astype(np.uint64)
    amax = arr.max(0).astype(np.uint64) + 1
    keys = np.zeros(arr.shape[0], np.uint64)
    for j in range(arr.shape[1] - 1):
        keys += arr[:, j]
        keys *= amax[j + 1]
    keys += arr[:, -1]
    return keys


def grid_sample_pick(keys: np.ndarray, offsets: np.ndarray) -> np.ndarray:
    """One index per occupied voxel, voxels in key order; ``offsets``
    rotates the pick within each voxel (stable sort: equal keys keep their
    input order)."""
    order = np.argsort(keys, kind="stable")
    _, counts = np.unique(keys[order], return_counts=True)
    starts = np.cumsum(np.insert(counts, 0, 0))[:-1]
    return order[starts + offsets[: counts.size] % counts]


@TRANSFORMS.register_module()
class GridSample:
    """Voxel grid sampling (reference `transform.py:796-933`).

    train mode: one random point per voxel. test mode: every rotation of
    per-voxel picks, emitted as a fragment list for vote-based inference.
    """

    def __init__(self, grid_size=0.05, hash_type="fnv", mode="train",
                 keys=("coord", "color", "normal", "segment"),
                 return_inverse=False, return_grid_coord=False,
                 return_min_coord=False):
        self.grid_size = grid_size
        self.hash = fnv_hash_vec if hash_type == "fnv" else ravel_hash_vec
        assert mode in ("train", "test")
        self.mode = mode
        self.keys = keys
        self.return_inverse = return_inverse
        self.return_grid_coord = return_grid_coord
        self.return_min_coord = return_min_coord

    def __call__(self, data, rng):
        assert "coord" in data
        scaled = data["coord"] / np.array(self.grid_size)
        grid = np.floor(scaled).astype(int)
        gmin = grid.min(0)
        grid -= gmin
        key = self.hash(grid)
        if (
            self.mode == "train"
            and not self.return_inverse
            and "sampled_index" not in data
        ):
            idx_unique = grid_sample_pick(
                key.astype(np.uint64),
                rng.integers(0, np.iinfo(np.int64).max, key.shape[0]),
            )
            if self.return_grid_coord:
                data["grid_coord"] = grid[idx_unique]
            if self.return_min_coord:
                data["min_coord"] = (gmin * self.grid_size).reshape(1, 3)
            for k in self.keys:
                if k in data:
                    data[k] = data[k][idx_unique]
            return data
        idx_sort = np.argsort(key)
        key_sort = key[idx_sort]
        _, inverse, count = np.unique(key_sort, return_inverse=True,
                                      return_counts=True)
        starts = np.cumsum(np.insert(count, 0, 0)[:-1])
        if self.mode == "train":
            idx_select = starts + rng.integers(0, count.max(), count.size) % count
            idx_unique = idx_sort[idx_select]
            if "sampled_index" in data:
                idx_unique = np.unique(
                    np.append(idx_unique, data["sampled_index"])
                )
                mask = np.zeros(len(data["segment"]), bool)
                mask[data["sampled_index"]] = True
                data["sampled_index"] = np.where(mask[idx_unique])[0]
            if self.return_inverse:
                inv = np.zeros_like(inverse)
                inv[idx_sort] = inverse
                data["inverse"] = inv
            if self.return_grid_coord:
                data["grid_coord"] = grid[idx_unique]
            if self.return_min_coord:
                data["min_coord"] = (gmin * self.grid_size).reshape(1, 3)
            for k in self.keys:
                if k in data:
                    data[k] = data[k][idx_unique]
            return data
        # test mode -> fragment list over per-voxel rotations
        fragments: List[Dict] = []
        for i in range(count.max()):
            idx_part = idx_sort[starts + i % count]
            part = dict(index=idx_part)
            if self.return_grid_coord:
                part["grid_coord"] = grid[idx_part]
            for k, v in data.items():
                if k in self.keys:
                    part[k] = v[idx_part]
                elif k != "index":
                    part[k] = v
            fragments.append(part)
        return fragments


@TRANSFORMS.register_module()
class SphereCrop:
    """Keep the ``point_max`` points nearest a center: a random point
    ("random") or the middle one ("center"). Mode "all" returns a list of
    covering crops (reference `transform.py:944-1001`): each is centred on
    the point of lowest priority (small random priorities, raised for the
    points a crop took, the more the nearer its centre) until every point
    lies in a crop; a crop carries its squared distances as ``weight``."""

    def __init__(self, point_max=80000, sample_rate=None, mode="random"):
        self.point_max = point_max
        self.sample_rate = sample_rate
        assert mode in ("random", "center", "all")
        self.mode = mode

    def __call__(self, data, rng):
        point_max = (
            int(self.sample_rate * data["coord"].shape[0])
            if self.sample_rate is not None else self.point_max
        )
        n = data["coord"].shape[0]
        if self.mode == "all":
            if "index" not in data:
                data["index"] = np.arange(n)
            if n <= point_max:
                out = dict(data)
                out["weight"] = np.zeros(n)
                return [out]
            parts = []
            coord_p = rng.random(n) * 1e-3
            covered = np.zeros(n, bool)
            while not covered.all():
                init = np.argmin(coord_p)
                d2 = np.sum((data["coord"] - data["coord"][init]) ** 2, 1)
                # numpy's default sort, as JAX's: ties fall as they do there
                idx_crop = np.argsort(d2)[:point_max]
                part = {k: (v[idx_crop] if k in POINT_KEYS and hasattr(v, "__len__")
                            and len(v) == n else v)
                        for k, v in data.items()}
                part["weight"] = d2[idx_crop]
                parts.append(part)
                coord_p[idx_crop] += np.square(
                    1 - d2[idx_crop] / max(d2[idx_crop].max(), 1e-12))
                covered[idx_crop] = True
            return parts
        if n > point_max:
            if self.mode == "random":
                center = data["coord"][rng.integers(n)]
            else:
                center = data["coord"][n // 2]
            idx = np.argsort(np.sum((data["coord"] - center) ** 2, 1))[:point_max]
            take(data, idx)
        return data


@TRANSFORMS.register_module()
class ShufflePoint:
    def __call__(self, data, rng):
        idx = rng.permutation(data["coord"].shape[0])
        return take(data, idx)


@TRANSFORMS.register_module()
class ToTensor:
    """A no-op, as in the JAX package: arrays stay numpy until collation."""

    def __call__(self, data, rng=None):
        return data


@TRANSFORMS.register_module()
class Add:
    def __init__(self, keys_dict=None):
        self.keys_dict = keys_dict or {}

    def __call__(self, data, rng=None):
        data.update(self.keys_dict)
        return data


@TRANSFORMS.register_module()
class HueSaturationTranslation:
    """HSV-space hue and saturation jitter (reference `transform.py:651-716`)."""

    def __init__(self, hue_max=0.5, saturation_max=0.2):
        self.hue_max = hue_max
        self.saturation_max = saturation_max

    @staticmethod
    def rgb_to_hsv(rgb):
        hsv = np.zeros_like(rgb)
        maxc = rgb.max(-1)
        minc = rgb.min(-1)
        delta = maxc - minc
        hsv[..., 2] = maxc
        m = maxc > 0
        hsv[..., 1][m] = delta[m] / maxc[m]
        dz = delta.copy()
        dz[delta == 0] = 1.0
        rc = (maxc - rgb[..., 0]) / dz
        gc = (maxc - rgb[..., 1]) / dz
        bc = (maxc - rgb[..., 2]) / dz
        h = 4.0 + gc - rc
        h[rgb[..., 1] == maxc] = (2.0 + rc - bc)[rgb[..., 1] == maxc]
        h[rgb[..., 0] == maxc] = (bc - gc)[rgb[..., 0] == maxc]
        h[delta == 0] = 0.0
        hsv[..., 0] = (h / 6.0) % 1.0
        return hsv

    @staticmethod
    def hsv_to_rgb(hsv):
        h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
        i = np.floor(h * 6.0)
        f = h * 6.0 - i
        p = v * (1 - s)
        q = v * (1 - s * f)
        t = v * (1 - s * (1 - f))
        i = i.astype(int) % 6
        out = np.zeros_like(hsv)
        lut = [(v, t, p), (q, v, p), (p, v, t), (p, q, v), (t, p, v), (v, p, q)]
        for k, (r, g, b) in enumerate(lut):
            m = i == k
            out[..., 0][m] = r[m]
            out[..., 1][m] = g[m]
            out[..., 2][m] = b[m]
        return out

    def __call__(self, data, rng):
        if "color" in data:
            hsv = self.rgb_to_hsv(data["color"][:, :3] / 255.0)
            hsv[..., 0] = (hsv[..., 0] + rng.uniform(-self.hue_max, self.hue_max)) % 1.0
            hsv[..., 1] = np.clip(
                hsv[..., 1] + rng.uniform(-self.saturation_max, self.saturation_max),
                0, 1)
            data["color"][:, :3] = np.clip(self.hsv_to_rgb(hsv) * 255.0, 0, 255)
        return data


@TRANSFORMS.register_module()
class CropBoundary:
    """Drop the points labelled 0 or 1 (reference `transform.py:1060-1075`)."""

    def __call__(self, data, rng=None):
        seg = data["segment"]
        keep = np.where((seg != 0) & (seg != 1))[0]
        return take(data, keep)


@TRANSFORMS.register_module()
class ClipGaussianJitter:
    """Gaussian coordinate jitter as the reference's active implementation
    (`transform.py:371-383`) has it: despite the name it neither clips nor
    scales; a ``normal(mean, std)`` draw is added to the coordinates."""

    def __init__(self, mean=0.0, std=1.0):
        self.mean = mean
        self.std = std

    def __call__(self, data, rng):
        if "coord" in data:
            data["coord"] = data["coord"] + rng.normal(
                self.mean, self.std, data["coord"].shape).astype(data["coord"].dtype)
        return data


@TRANSFORMS.register_module()
class RandomColorJitter:
    """Torchvision-style colour jitter on 0-255 RGB (reference
    `transform.py:467-546`): brightness, contrast and saturation factors
    drawn from [1 - v, 1 + v] and a hue shift from [-h, h], in that order,
    applied with probability ``p``."""

    def __init__(self, brightness=0.0, contrast=0.0, saturation=0.0,
                 hue=0.0, p=0.95):
        self.brightness = brightness
        self.contrast = contrast
        self.saturation = saturation
        self.hue = min(max(hue, 0.0), 0.5)
        self.p = p

    @staticmethod
    def _blend(a, b, f):
        return np.clip(f * a + (1 - f) * b, 0, 255)

    def __call__(self, data, rng):
        if "color" not in data or rng.random() >= self.p:
            return data
        color = data["color"][:, :3].astype(np.float64)
        if self.brightness > 0:
            f = rng.uniform(max(0, 1 - self.brightness), 1 + self.brightness)
            color = np.clip(color * f, 0, 255)
        if self.contrast > 0:
            f = rng.uniform(max(0, 1 - self.contrast), 1 + self.contrast)
            gray = (0.299 * color[:, 0] + 0.587 * color[:, 1]
                    + 0.114 * color[:, 2]).mean()
            color = self._blend(color, gray, f)
        if self.saturation > 0:
            f = rng.uniform(max(0, 1 - self.saturation), 1 + self.saturation)
            gray = (0.299 * color[:, 0] + 0.587 * color[:, 1]
                    + 0.114 * color[:, 2])[:, None]
            color = self._blend(color, gray, f)
        if self.hue > 0:
            shift = rng.uniform(-self.hue, self.hue)
            hsv = HueSaturationTranslation.rgb_to_hsv(color / 255.0)
            hsv[..., 0] = (hsv[..., 0] + shift) % 1.0
            color = np.clip(HueSaturationTranslation.hsv_to_rgb(hsv) * 255.0, 0, 255)
        data["color"][:, :3] = color.astype(data["color"].dtype)
        return data


@TRANSFORMS.register_module()
class ContrastiveViewsGenerator:
    """Two independently augmented views under ``view1_``/``view2_``
    prefixes (reference `transform.py:1081-1104`, used by MSC): copies of
    ``view_keys`` through ``view_trans_cfg``, view 1 first, both drawing in
    turn from the one generator."""

    def __init__(self, view_keys=("coord", "color", "normal", "origin_coord"),
                 view_trans_cfg=None):
        self.view_keys = view_keys
        self.view_trans = Compose(view_trans_cfg)

    def __call__(self, data, rng):
        for prefix in ("view1_", "view2_"):
            view = {k: data[k].copy() for k in self.view_keys if k in data}
            view = self.view_trans(view, rng)
            for k, v in view.items():
                data[prefix + k] = v
        return data


@TRANSFORMS.register_module()
class InstanceParser:
    """Instance-segmentation targets (reference `transform.py:1106-1161`):
    the surviving instances renumbered densely, per-point instance
    centroids, and per-instance boxes ``[center(3), size(3), theta(1),
    class(1)]`` with the class shifted down past the ignored segment
    classes. As in the reference and JAX, a -1 instance on a point of a
    valid class is renumbered like a real instance."""

    def __init__(self, segment_ignore_index=(-1, 0, 1), instance_ignore_index=-1):
        self.segment_ignore_index = segment_ignore_index
        self.instance_ignore_index = instance_ignore_index

    def __call__(self, data, rng=None):
        coord = data["coord"]
        segment = data["segment"]
        instance = np.asarray(data["instance"]).reshape(-1).copy()
        keep = ~np.isin(segment, self.segment_ignore_index)
        instance[~keep] = self.instance_ignore_index
        unique, inverse = np.unique(instance[keep], return_inverse=True)
        instance[keep] = inverse
        n_inst = len(unique)
        centroid = np.full((coord.shape[0], 3), self.instance_ignore_index, np.float32)
        bbox = np.full((n_inst, 8), self.instance_ignore_index, np.float32)
        vacancy = [i for i in self.segment_ignore_index if i >= 0]
        for inst_id in range(n_inst):
            m = instance == inst_id
            pts = coord[m]
            lo, hi = pts.min(0), pts.max(0)
            centroid[m] = pts.mean(0)
            cls = float(segment[m][0])
            cls -= float(np.greater(cls, vacancy).sum())
            bbox[inst_id, :3] = (hi + lo) / 2
            bbox[inst_id, 3:6] = hi - lo
            bbox[inst_id, 6] = 0.0
            bbox[inst_id, 7] = cls
        data["instance"] = instance
        data["instance_centroid"] = centroid
        data["bbox"] = bbox
        return data
