"""Batch loaders: sampling, Mix3D, static-bucket collation, prefetch.

Port of `TrainLoader` and `EvalLoader` of `cdsegnet_tpu/data/loader.py`
(reference `pointcept/engines/train.py:292-342`): scenes are sampled and
transformed on the host with numpy generators drawn exactly as JAX draws
them, merged by Mix3D, collated into fixed-size buckets and, for training,
prefetched on a background thread so host preprocessing overlaps the step
on the GPU. Where JAX's loader stacks every device's bucket for one
controller, each rank of the port loads only its own (`TrainLoader`'s
``rank``). With ``pair_feat_keys`` the loader collates MSC's two views per
scene (`collate_pair_scenes`, no Mix3D). `MultiDatasetLoader` round-robins
over one `TrainLoader` per dataset (PPT). An exception in the prefetch
thread is raised in the consumer.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from cdsegnet_torch.data.collate import collate_pair_scenes, collate_scenes, mix3d


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

    ``pair_feat_keys``: the scenes are MSC's view pairs, collated into
    ``view1_*``/``view2_*`` buckets by `collate_pair_scenes` with those
    reconstruction targets, without Mix3D (meaningless across views) and
    without micro buckets.
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
        if pair_feat_keys is not None and microbatch != 1:
            raise ValueError("paired views (MSC) take no micro buckets")
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
        self.pair_feat_keys = None if pair_feat_keys is None else tuple(pair_feat_keys)
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
        if self.pair_feat_keys is not None:
            return collate_pair_scenes(scenes, self.num_points, spd, self.pair_feat_keys)
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


class MultiDatasetLoader:
    """Round-robin over one loader per dataset with loop-ratio weighting
    (JAX's `MultiDatasetLoader`, reference
    `pointcept/datasets/dataloader.py:23-112`, used for PPT joint training).

    The epoch is governed by the main (first) dataset: per cycle, dataset i
    contributes ``ratios[i]`` batches; a non-main dataset that runs out
    restarts, its r-th restart of epoch e drawing as epoch ``(e + 1) * 1000
    + r`` of its loader; the epoch ends when the main dataset runs out.
    Each batch carries ``_dataset_idx``, the index of its dataset."""

    def __init__(self, loaders: Sequence[TrainLoader], ratios: Sequence[int]):
        if len(loaders) != len(ratios):
            raise ValueError(f"{len(loaders)} loaders for {len(ratios)} ratios")
        self.loaders = list(loaders)
        self.ratios = list(ratios)

    def __len__(self) -> int:
        # reference `dataloader.py:98-103`
        main, r0 = len(self.loaders[0]), self.ratios[0]
        return main // r0 * sum(self.ratios) + main % r0

    def epoch(self, epoch: int) -> Iterator[Dict[str, np.ndarray]]:
        iters = [iter(loader.epoch(epoch)) for loader in self.loaders]
        restarts = [0] * len(iters)
        try:
            while True:
                for i in range(len(iters)):
                    for _ in range(self.ratios[i]):
                        try:
                            batch = next(iters[i])
                        except StopIteration:
                            if i == 0:
                                return
                            restarts[i] += 1
                            iters[i] = iter(self.loaders[i].epoch(
                                (epoch + 1) * 1000 + restarts[i]))
                            batch = next(iters[i])
                        batch["_dataset_idx"] = i
                        yield batch
        finally:
            for it in iters:  # stop the loaders' prefetch threads
                it.close()
