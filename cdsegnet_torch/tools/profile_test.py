"""Profile one fragment of the port's tester on one GPU.

Usage, from the root of a checkout::

    python -m cdsegnet_torch.tools.profile_test --out DIR

Writes the synthetic room (`utils.synthetic.room_scene`) as a ScanNet scene
to a temporary directory, runs the test pipeline of
`configs/scannet/cdsegnet.py` on it (13 augmentations, 2 cm test-mode grid
sampling) and builds the config's model (random weights from a seed). For
the first fragment (131,072-slot bucket) it reports host-clock times
(median of 10 after 3 warm-ups, each ending in a synchronize) of the
fragment's preparation (collation, copy to the device, noise), its forward
with geometry, and the whole `SemSegTester.predict_fragment`; then, from
`torch.profiler` over 3 calls, the device time per fragment, the device's
idle share and the device time by kernel family, as `profile_ssi` does.
The full tables go to ``<out>/profile_test.txt``.
"""

from __future__ import annotations

import argparse
import os
import shutil
import tempfile

import numpy as np
import torch

from cdsegnet_torch.data.datasets import build_dataset
from cdsegnet_torch.engine.config import Config
from cdsegnet_torch.engine.test import SemSegTester
from cdsegnet_torch.tools.profile_ssi import ROOT, card_name, host_ms, profile_steps
from cdsegnet_torch.utils.synthetic import room_scene


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", required=True, help="directory for profile_test.txt")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_test needs a CUDA device")
    card = card_name()
    tmp = tempfile.mkdtemp(prefix="profile_test_")
    try:
        os.makedirs(os.path.join(tmp, "val"))
        torch.save(room_scene(), os.path.join(tmp, "val", "scene0000_00.pth"))
        cfg = Config.fromfile(os.path.join(ROOT, "configs", "scannet", "cdsegnet.py"))
        cfg.data.test["data_root"] = tmp
        scene = build_dataset(dict(cfg.data.test)).get(0, np.random.default_rng(cfg.seed))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    tester = SemSegTester(cfg)
    frag = scene["fragment_list"][0]
    n_frag, point, noise = tester._prepare_fragment(frag, 0, None)
    res = dict(
        card=card, fragments=len(scene["fragment_list"]), points=n_frag,
        bucket=point.num_points,
        prepare_ms=host_ms(lambda: tester._prepare_fragment(frag, 0, None)),
        forward_ms=host_ms(lambda: tester.forward_fragment(point, noise)),
        step_ms=host_ms(lambda: tester.predict_fragment(frag, 0)),
    )
    profile_steps(lambda: tester.predict_fragment(frag, 0), 3, res,
                  os.path.join(args.out, "profile_test.txt"))


if __name__ == "__main__":
    main()
