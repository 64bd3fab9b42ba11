"""Space-filling-curve serialization codes (z-order and Hilbert).

Port of `cdsegnet_tpu/ops/serialization.py`: word-level int64 bit arithmetic
(Morton bit spreading and Skilling's transpose-form Hilbert algorithm), with
``code = batch << (3 * depth) | curve_code`` and the x axis in the most
significant bit of each 3-bit group.
"""

from __future__ import annotations

from typing import Optional

import torch

ORDERS = ("z", "z-trans", "hilbert", "hilbert-trans")


def _spread3(v: torch.Tensor) -> torch.Tensor:
    """Spread the low 21 bits of ``v`` so bit i moves to bit 3*i (Morton)."""
    v = v.to(torch.int64) & 0x1FFFFF
    v = (v | (v << 32)) & 0x1F00000000FFFF
    v = (v | (v << 16)) & 0x1F0000FF0000FF
    v = (v | (v << 8)) & 0x100F00F00F00F00F
    v = (v | (v << 4)) & 0x10C30C30C30C30C3
    v = (v | (v << 2)) & 0x1249249249249249
    return v


def _axes(grid_coord: torch.Tensor, depth: int):
    mask = (1 << depth) - 1
    g = grid_coord.to(torch.int64)
    return [g[:, i] & mask for i in range(3)]


def z_order_encode(grid_coord: torch.Tensor, depth: int = 16) -> torch.Tensor:
    """Morton-encode int grid coords ``(N, 3)`` -> int64 codes ``(N,)``."""
    x, y, z = _axes(grid_coord, depth)
    return (_spread3(x) << 2) | (_spread3(y) << 1) | _spread3(z)


def _hilbert_axes_to_transpose(x, y, z, depth: int):
    """Skilling AxesToTranspose for 3 dims, vectorized over points."""
    X = [x, y, z]
    zero = torch.zeros_like(x)
    Q = 1 << (depth - 1)
    while Q > 1:
        P = Q - 1
        for i in range(3):
            cond = (X[i] & Q) != 0
            # invert low bits of X[0] where the bit is set; else exchange
            t = torch.where(cond, zero, (X[0] ^ X[i]) & P)
            X0 = torch.where(cond, X[0] ^ P, X[0] ^ t)
            Xi = X[i] ^ t
            X[0] = X0
            if i != 0:
                X[i] = Xi
        Q >>= 1
    # Gray encode
    X[1] = X[1] ^ X[0]
    X[2] = X[2] ^ X[1]
    t = zero
    Q = 1 << (depth - 1)
    while Q > 1:
        t = torch.where((X[2] & Q) != 0, t ^ (Q - 1), t)
        Q >>= 1
    return [xi ^ t for xi in X]


def hilbert_encode(grid_coord: torch.Tensor, depth: int = 16) -> torch.Tensor:
    """Hilbert-encode int grid coords ``(N, 3)`` -> int64 codes ``(N,)``."""
    x, y, z = _axes(grid_coord, depth)
    X = _hilbert_axes_to_transpose(x, y, z, depth)
    return (_spread3(X[0]) << 2) | (_spread3(X[1]) << 1) | _spread3(X[2])


def encode(
    grid_coord: torch.Tensor,
    batch: Optional[torch.Tensor] = None,
    depth: int = 16,
    order: str = "z",
) -> torch.Tensor:
    """Serialize grid coords into int64 codes with the batch index in the
    high bits."""
    if order not in ORDERS:
        raise ValueError(f"unknown order {order!r}")
    if order in ("z-trans", "hilbert-trans"):
        grid_coord = grid_coord[:, [1, 0, 2]]
    if order.startswith("z"):
        code = z_order_encode(grid_coord, depth=depth)
    else:
        code = hilbert_encode(grid_coord, depth=depth)
    if batch is not None:
        code = (batch.to(torch.int64) << (depth * 3)) | code
    return code
