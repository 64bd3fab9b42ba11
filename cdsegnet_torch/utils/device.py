"""Device selection for the port's entry points."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``device`` as a `torch.device`; ``None`` means the GPU.

    Raises when no GPU is present and the caller did not name a device: the
    port never falls back to the CPU on its own.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)
