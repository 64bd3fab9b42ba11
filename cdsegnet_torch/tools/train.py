"""Training entry point of the port.

Usage:
    python -m cdsegnet_torch.tools.train --config-file configs/scannet/cdsegnet.py \
        [--options save_path=exp/scannet seed=...] [--device cpu]

Counterpart of `tools/train.py`: it dumps the merged config to
``<save_path>/config.py`` and runs ``cfg.train`` (`DefaultTrainer` by
default) from the `TRAINERS` registry. It runs on the GPU unless
``--device`` names another device, and raises when there is no GPU and none
is named. `main(argv)` takes the arguments as a list and returns the
trainer after its run.
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional

from cdsegnet_torch.engine.config import Config, parse_options
from cdsegnet_torch.engine.train import TRAINERS
from cdsegnet_torch.utils.device import resolve_device


def main(argv: Optional[List[str]] = None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config-file", required=True)
    ap.add_argument("--options", nargs="*", default=None, help="key=value overrides")
    ap.add_argument("--device", default=None, help="torch device (default: the GPU)")
    args = ap.parse_args(argv)
    cfg = Config.fromfile(args.config_file)
    cfg.merge_from_dict(parse_options(args.options))
    device = resolve_device(args.device)
    save_path = cfg.get("save_path", "exp/default")
    os.makedirs(save_path, exist_ok=True)
    cfg.dump(os.path.join(save_path, "config.py"))
    trainer = TRAINERS.build(dict(cfg.get("train", dict(type="DefaultTrainer"))),
                             cfg=cfg, device=device)
    trainer.train()
    return trainer


if __name__ == "__main__":
    main()
