"""Checkpoint save/load (reference `pointcept/engines/hooks/misc.py:146-249`).

Port of `cdsegnet_tpu/engine/checkpoint.py` with the same surface: named
checkpoints (``model_last``, ``model_best``, ``epoch_N`` snapshots of which
the newest ``keep_last`` are kept) in one directory. Each is one file written
with `torch.save`, atomically (``<name>.tmp``, then `os.replace`, as the
reference does). A checkpoint is the dict that `snapshot` makes: the model's
``state_dict`` and the step, plus the optimizer's and the generators' states
when given them. In a process group of several ranks (`parallel.dist`) only
rank 0 writes, every rank waits at a barrier after each write, every rank
reads, and a checkpoint carries every rank's generators (``rank_generators``),
each rank restoring its own. Orbax checkpoints of the JAX package are read
through `convert_jax_checkpoint.py` (repository root), which writes the
model and the step of one in this format (`utils.weights.load_jax_train_state`).
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import torch

from cdsegnet_torch.parallel import dist


def snapshot(model: torch.nn.Module, step: int = 0, optimizer=None,
             generators: Optional[Dict[str, torch.Generator]] = None) -> Dict[str, Any]:
    """The state a checkpoint holds: ``model`` (its ``state_dict``),
    ``step``, and ``optimizer`` and ``generators`` when given. With
    ``generators`` in a group of several ranks every rank must call it: it
    gathers each rank's generator states into ``rank_generators`` (rank
    0's are also ``generators``)."""
    state: Dict[str, Any] = dict(model=model.state_dict(), step=int(step))
    if optimizer is not None:
        state["optimizer"] = optimizer.state_dict()
    if generators is not None:
        ranks = dist.all_gather_object({k: g.get_state() for k, g in generators.items()})
        state["generators"] = ranks[0]
        if len(ranks) > 1:
            state["rank_generators"] = ranks
    return state


class CheckpointManager:
    def __init__(self, ckpt_dir: str, keep_last: int = 3):
        self.ckpt_dir = os.path.abspath(ckpt_dir)
        os.makedirs(self.ckpt_dir, exist_ok=True)
        self.keep_last = keep_last

    def _path(self, name: str) -> str:
        return os.path.join(self.ckpt_dir, name)

    def save(self, state: Dict[str, Any], name: str = "model_last",
             overwrite: bool = True) -> None:
        """Write ``state`` as ``name`` (rank 0; in a group, every rank
        calls it and waits until the file is in place)."""
        path = self._path(name)
        if not overwrite and os.path.exists(path):
            raise FileExistsError(path)
        if dist.is_main():
            tmp = path + ".tmp"
            torch.save(state, tmp)
            os.replace(tmp, path)
        dist.barrier()

    def save_epoch(self, state: Dict[str, Any], epoch: int, is_best: bool,
                   save_snapshot: bool = False) -> None:
        self.save(state, "model_last")
        if is_best:
            self.save(state, "model_best")
        if save_snapshot:
            self.save(state, f"epoch_{epoch}")
            if dist.is_main():
                self._gc_snapshots()
            dist.barrier()

    def _gc_snapshots(self) -> None:
        snaps = sorted(
            (d for d in os.listdir(self.ckpt_dir)
             if d.startswith("epoch_") and not d.endswith(".tmp")),
            key=lambda d: int(d.split("_")[1]),
        )
        for d in snaps[: -self.keep_last] if self.keep_last > 0 else []:
            os.remove(self._path(d))

    def restore(self, model: torch.nn.Module, name: str = "model_last",
                optimizer=None,
                generators: Optional[Dict[str, torch.Generator]] = None
                ) -> Optional[Dict[str, Any]]:
        """Load checkpoint ``name`` into ``model`` (strictly) and, when
        given, ``optimizer`` and this rank's ``generators`` (a checkpoint
        of another number of ranks raises); returns the checkpoint, or None
        when there is none."""
        state = self.restore_raw(name)
        if state is None:
            return None
        if generators:
            ranks = state.get("rank_generators", [state["generators"]])
            if len(ranks) != dist.world_size():
                raise ValueError(f"checkpoint {name!r} holds the generators of "
                                 f"{len(ranks)} ranks, this run has {dist.world_size()}")
        model.load_state_dict(state["model"])
        if optimizer is not None:
            optimizer.load_state_dict(state["optimizer"])
        if generators:
            for k, g in generators.items():
                g.set_state(ranks[dist.rank()][k])
        return state

    def restore_raw(self, name: str = "model_last") -> Optional[Dict[str, Any]]:
        """The checkpoint as saved, tensors on the CPU; None when absent."""
        path = self._path(name)
        if not os.path.exists(path):
            return None
        return torch.load(path, map_location="cpu", weights_only=True)

    def has(self, name: str = "model_last") -> bool:
        return os.path.exists(self._path(name))
