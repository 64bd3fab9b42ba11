"""Training cells whose features lead with the coordinates: the
``train_buckets`` loop (`loops/train_buckets.py`), run as it is, over
buckets whose features are Collect's ``feat_keys=("coord", "color",
"normal")``, 9 channels, as Pointcept's PTv1 and PTv2 ScanNet recipes
feed them (the other training cells feed color and normal).

The mix (kind ``train_buckets_coord``) takes the parameters of a
``train_buckets`` mix. The coordinates are those the model is given, after
the pipeline's last CenterShift; padding rows stay zero.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from bench_h100.loops.train_buckets import bucket_counts, reference_steps, run  # noqa: F401
from bench_h100.loops.train_buckets import make as make_color_normal


def make(mix: Dict, seed: int) -> List[Dict[str, np.ndarray]]:
    return [dict(b, feat=np.concatenate([b["coord"], b["feat"]], 1))
            for b in make_color_normal(mix, seed)]
