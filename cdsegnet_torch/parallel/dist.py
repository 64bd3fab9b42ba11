"""Process groups for data-parallel training and fragment-parallel testing.

Counterpart of `cdsegnet_tpu/parallel/mesh.py`. The JAX package runs one
controller over a 1-D device mesh and averages with `pmean` inside
`shard_map`; the port runs one process per GPU, as the reference does with
DDP (`pointcept/engines/launch.py:36-137`), and averages with collectives
over a `torch.distributed` process group.

A group is built either by `launch`, which spawns one process per GPU with
`torch.multiprocessing` (reference `launch.py:74-113`), or from the
environment that ``torchrun`` sets (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``) by `init_from_env`. The
backend is ``nccl`` for CUDA devices and ``gloo`` for the CPU; a caller
may name another (two gloo ranks can share one GPU, which NCCL refuses),
and no backend is ever swapped for another behind the caller's back. Each
rank runs on ``cuda:<local_rank>`` unless the caller names its device; a
rank runs on the CPU only when asked.

Without a process group every query answers for one process (rank 0 of a
world of 1) and every reduction is the identity; in a group of one the
collectives still run, so that a one-rank group exercises its backend.
"""

from __future__ import annotations

import datetime
import os
import shutil
import tempfile
import time
from typing import Any, Callable, List, Optional, Sequence, Union

import torch
import torch.distributed as dist

DeviceLike = Optional[Union[str, torch.device]]
TIMEOUT = datetime.timedelta(minutes=10)  # a rank that stops fails its peers


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if is_initialized() else 0


def local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", rank())) if is_initialized() else 0


def is_main() -> bool:
    return rank() == 0


def barrier() -> None:
    if is_initialized():
        dist.barrier()


def default_backend(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def rank_device(device: DeviceLike = None) -> torch.device:
    """This rank's device: ``device`` when named, else ``cuda:<local_rank>``.
    Raises when there is no GPU and no device is named."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
    return torch.device("cuda", local_rank())


def init(backend: Optional[str], init_method: str, rank_: int, world: int,
         device: torch.device) -> None:
    """Join the group ``init_method`` as rank ``rank_`` of ``world`` on
    ``device`` (``backend`` None: `default_backend`)."""
    backend = backend or default_backend(device)
    extra = {}
    if device.type == "cuda":
        torch.cuda.set_device(device)
        if backend == "nccl" and device.index is not None:
            extra["device_id"] = device  # NCCL binds the rank to it at once
    dist.init_process_group(backend, init_method=init_method, rank=rank_,
                            world_size=world, timeout=TIMEOUT, **extra)


def init_from_env(device: DeviceLike = None, backend: Optional[str] = None) -> bool:
    """Join the group that ``torchrun`` describes in the environment; False
    (and nothing done) when the environment describes none."""
    if is_initialized() or "WORLD_SIZE" not in os.environ or "RANK" not in os.environ:
        return False
    dev = rank_device(device) if device is not None else torch.device(
        "cuda", int(os.environ.get("LOCAL_RANK", 0)))
    init(backend, "env://", int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]), dev)
    return True


def destroy() -> None:
    """Leave the group (the last collective call of a rank)."""
    if is_initialized():
        dist.destroy_process_group()


def _worker(local: int, fn: Callable, args: Sequence, world: int, init_method: str,
            backend: Optional[str], device: DeviceLike) -> None:
    os.environ["LOCAL_RANK"] = str(local)
    dev = torch.device(device) if device is not None else torch.device("cuda", local)
    init(backend, init_method, local, world, dev)
    try:
        fn(*args)
    finally:
        destroy()


def launch(fn: Callable, num_procs: int, args: Sequence = (),
           backend: Optional[str] = None, device: DeviceLike = None,
           timeout: Optional[float] = None) -> None:
    """Run ``fn(*args)`` in ``num_procs`` spawned processes, one group of
    that size: rank r on ``device`` (``cuda:r`` when None). ``fn`` must be
    importable (a module-level function). The group meets through a file
    store in a fresh temporary directory (no port to collide with another
    group's). Returns when every rank has returned; raises when one fails,
    or kills them all and raises `TimeoutError` after ``timeout`` seconds."""
    if device is None and torch.cuda.device_count() < num_procs:
        raise RuntimeError(f"{num_procs} ranks need {num_procs} GPUs, "
                           f"{torch.cuda.device_count()} found; name a device to share one")
    store_dir = tempfile.mkdtemp(prefix="cdsegnet_dist_")
    init_method = "file://" + os.path.join(store_dir, "store")
    try:
        ranks = torch.multiprocessing.start_processes(
            _worker, args=(fn, tuple(args), num_procs, init_method, backend,
                           None if device is None else str(device)),
            nprocs=num_procs, join=False, start_method="spawn")
        deadline = None if timeout is None else time.monotonic() + timeout
        while not ranks.join(timeout=None if deadline is None else 1.0):
            if deadline is not None and time.monotonic() > deadline:
                for p in ranks.processes:
                    p.kill()
                raise TimeoutError(f"{num_procs} ranks of {fn.__name__} still ran "
                                   f"after {timeout} s")
    finally:
        shutil.rmtree(store_dir, ignore_errors=True)


# ---- reductions -------------------------------------------------------------

def flat_all_reduce_(tensors: Sequence[torch.Tensor]) -> None:
    """Sum each tensor over the ranks in place: one collective over one
    flat f32 buffer (the tensors share a device)."""
    if not tensors:
        return
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    if is_initialized():
        dist.all_reduce(flat)
    offset = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[offset:offset + n].view_as(t))
        offset += n


def all_reduce_sum_(tensor: torch.Tensor) -> torch.Tensor:
    """Sum ``tensor`` over the ranks in place (exact for integers)."""
    if is_initialized():
        dist.all_reduce(tensor)
    return tensor


def broadcast_(tensor: torch.Tensor, src: int) -> torch.Tensor:
    """``tensor`` of rank ``src`` on every rank, in place."""
    if is_initialized():
        dist.broadcast(tensor, src)
    return tensor


def all_gather_object(obj: Any) -> List[Any]:
    """Every rank's ``obj``, in rank order."""
    if not is_initialized():
        return [obj]
    out: List[Any] = [None] * world_size()
    dist.all_gather_object(out, obj)
    return out


def broadcast_object(obj: Any, src: int = 0) -> Any:
    """Rank ``src``'s ``obj`` on every rank."""
    if not is_initialized():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src)
    return box[0]
