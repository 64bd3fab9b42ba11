"""Batch loaders: sampling, Mix3D, static-bucket collation, prefetch.

Port of `TrainLoader` and `EvalLoader` of `cdsegnet_tpu/data/loader.py`
(reference `pointcept/engines/train.py:292-342`): scenes are sampled and
transformed on the host with numpy generators drawn exactly as JAX draws
them, merged by Mix3D, collated into fixed-size buckets and, for training,
prefetched on a background thread so host preprocessing overlaps the step
on the GPU. Where JAX's loader stacks every device's bucket for one
controller, each rank of the port loads only its own (`TrainLoader`'s
``rank``). Paired views (MSC) and `MultiDatasetLoader` are not ported and
raise `NotImplementedError`. An exception in the prefetch thread is raised
in the consumer.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from cdsegnet_torch.data.collate import collate_scenes, mix3d


class TrainLoader:
    """Epoch-based shuffled loader producing one rank's static batches.

    Each step takes ``num_devices * scenes_per_device`` scene ids from the
    epoch's permutation (`default_rng(seed + epoch)`, as JAX's), and rank
    ``rank`` loads, transforms and collates its own slice of them, at
    ``rank * scenes_per_device``, into a bucket of ``num_points`` slots
    (post-Mix3D). With ``microbatch`` m > 1 the bucket is m micro buckets
    stacked on a leading axis (JAX's `_collate_micro`), each holding
    ``scenes_per_device / m`` scenes padded to ``num_points / m``, with
    Mix3D inside each micro bucket and none across them.

    The augmentations draw from ``default_rng((seed, epoch, step,
    0xC0FFEE))`` on rank 0, as JAX draws its first device's; rank r > 0
    draws from ``(seed, epoch, step, 0xC0FFEE, r)``, where JAX's device r
    continues the first device's stream (replaying those draws would cost
    every rank the host work of all the ranks before it).
    """

    def __init__(
        self,
        dataset,
        num_devices: int = 1,
        scenes_per_device: int = 2,
        num_points: int = 204800,
        mix_prob: float = 0.0,
        seed: int = 0,
        feat_dim: Optional[int] = None,
        drop_last: bool = True,
        prefetch: int = 2,
        pair_feat_keys: Optional[Sequence[str]] = None,
        microbatch: int = 1,
        rank: int = 0,
    ):
        if pair_feat_keys is not None:
            raise NotImplementedError(
                'paired views (MSC pretraining) are not ported (ROADMAP Queue 1: '
                '"The model zoo and the rest of the engine and data")')
        if not 0 <= rank < num_devices:
            raise ValueError(f"rank {rank} of num_devices={num_devices}")
        if microbatch < 1 or scenes_per_device % microbatch or num_points % microbatch:
            raise ValueError(f"microbatch={microbatch} must divide scenes_per_device="
                             f"{scenes_per_device} and num_points={num_points}")
        self.dataset = dataset
        self.num_devices = num_devices
        self.rank = rank
        self.scenes_per_device = scenes_per_device
        self.num_points = num_points
        self.mix_prob = mix_prob
        self.seed = seed
        self.feat_dim = feat_dim
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.microbatch = microbatch
        self.scenes_per_batch = num_devices * scenes_per_device

    def __len__(self) -> int:
        """Global batches per epoch (every rank takes one slice of each)."""
        n = len(self.dataset)
        if self.drop_last:
            return n // self.scenes_per_batch
        return (n + self.scenes_per_batch - 1) // self.scenes_per_batch

    def _epoch_indices(self, epoch: int) -> np.ndarray:
        rng = np.random.default_rng(self.seed + epoch)
        return rng.permutation(len(self.dataset))

    def _make_batch(self, idxs: Sequence[int], epoch: int, step: int):
        """This rank's bucket of the global batch ``idxs``."""
        key = (self.seed, epoch, step, 0xC0FFEE) + ((self.rank,) if self.rank else ())
        rng = np.random.default_rng(key)
        spd = self.scenes_per_device
        scene_ids = idxs[self.rank * spd: (self.rank + 1) * spd]
        scenes = [self.dataset.get(int(i), rng) for i in scene_ids]
        if self.microbatch == 1:
            return collate_scenes(mix3d(scenes, rng, self.mix_prob), self.num_points,
                                  spd, self.feat_dim)
        spm = spd // self.microbatch
        ppm = self.num_points // self.microbatch
        micros = [collate_scenes(mix3d(scenes[m * spm: (m + 1) * spm], rng, self.mix_prob),
                                 ppm, spm, self.feat_dim)
                  for m in range(self.microbatch)]
        return {k: np.stack([mb[k] for mb in micros]) for k in micros[0]}

    def _batches(self, idxs: np.ndarray, epoch: int) -> Iterator[Dict[str, np.ndarray]]:
        for step in range(len(self)):
            lo = step * self.scenes_per_batch
            yield self._make_batch(idxs[lo: lo + self.scenes_per_batch], epoch, step)

    def epoch(self, epoch: int) -> Iterator[Dict[str, np.ndarray]]:
        idxs = self._epoch_indices(epoch)
        if self.prefetch > 0:
            yield from self._prefetched(self._batches(idxs, epoch))
        else:
            yield from self._batches(idxs, epoch)

    def _prefetched(self, batches: Iterator) -> Iterator[Dict[str, np.ndarray]]:
        """``batches`` made on a thread, at most ``prefetch`` ahead; the
        thread stops when the consumer does."""
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        done = object()
        errors: List[Exception] = []

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    pass
            return False

        def worker():
            try:
                for batch in batches:
                    if not put(batch):
                        return
            except Exception as e:  # raised again in the consumer
                errors.append(e)
            finally:
                put(done)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is done:
                    break
                yield item
            if errors:
                raise errors[0]
        finally:
            stop.set()
            t.join()


class EvalLoader:
    """Sequential whole-scene loader (one scene per batch, bucketed size)."""

    def __init__(self, dataset, num_points: int, num_scenes: int = 1,
                 feat_dim: Optional[int] = None, seed: int = 0):
        self.dataset = dataset
        self.num_points = num_points
        self.num_scenes = num_scenes
        self.feat_dim = feat_dim
        self.seed = seed

    def __len__(self):
        return len(self.dataset)

    def __iter__(self):
        rng = np.random.default_rng(self.seed)
        for i in range(len(self.dataset)):
            scene = self.dataset.get(i, rng)
            yield collate_scenes([scene], self.num_points, self.num_scenes,
                                 self.feat_dim), scene


def MultiDatasetLoader(*args, **kwargs):
    raise NotImplementedError(
        'MultiDatasetLoader (round-robin multi-dataset training) is not ported '
        '(ROADMAP Queue 1: "The model zoo and the rest of the engine and data")')
