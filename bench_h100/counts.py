"""Operations and bytes that the measured work needs, and the card's peaks.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at its 700 W
limit): 989 TFLOP/s in bf16, 67 TFLOP/s in float32 outside the tensor
cores, 3.35 TB/s of HBM. Patch attention is counted as the port's smoke
test counts it: the allowed (query, key) pairs' products, each valid row of
the inputs read once and every row of the outputs written once, plus the
scene ids and validity; the backward needs four products per pair (dV, dP,
dQ, dK; no recompute counted), reads q, k, v, o, dO and the row
log-sum-exp of the valid rows and writes dq, dk, dv.
"""

from __future__ import annotations

from typing import Dict, Sequence

PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12
ELEMENT = {"bfloat16": 2, "float32": 4}


def attention_fwd(slots: int, valid: int, pairs: int, heads: int, dim: int, dtype: str):
    """(flops, bytes) of one forward launch."""
    e = ELEMENT[dtype]
    return 4.0 * dim * heads * pairs, (slots + 3.0 * valid) * heads * dim * e + 5.0 * slots


def attention_bwd(slots: int, valid: int, pairs: int, heads: int, dim: int, dtype: str):
    """(flops, bytes) of one backward (its dq and dk/dv launches together)."""
    e = ELEMENT[dtype]
    return (8.0 * dim * heads * pairs,
            5.0 * valid * heads * dim * e + 4.0 * valid * heads
            + 3.0 * slots * heads * dim * e + 5.0 * slots)


def bound_seconds(flops: float, nbytes: float, dtype: str) -> float:
    """The least time the card could take: the larger of operations over
    the peak rate and bytes over the memory bandwidth."""
    return max(flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES)


def attention_bounds(calls: Sequence, stats: Sequence[Dict], dtype: str) -> Dict[str, float]:
    """Summed bound seconds of the forward and the backward launches of one
    pass: ``calls`` are (level, channels, heads, patch)."""
    fwd = bwd = 0.0
    for lv, c, h, _ in calls:
        s = stats[lv]
        args = (s["slots"], s["valid"], s["attn_pairs"], h, c // h, dtype)
        fwd += bound_seconds(*attention_fwd(*args), dtype)
        bwd += bound_seconds(*attention_bwd(*args), dtype)
    return dict(fwd=fwd, bwd=bwd)
