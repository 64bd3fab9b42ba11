"""Training entry point of the port.

Usage:
    python -m cdsegnet_torch.tools.train --config-file configs/scannet/cdsegnet.py \
        [--options save_path=exp/scannet seed=...] [--num-gpus N] [--device cpu]

Counterpart of `tools/train.py` and the reference's `engines/launch.py`: it
dumps the merged config to ``<save_path>/config.py`` and runs ``cfg.train``
(`DefaultTrainer` by default) from the `TRAINERS` registry.

``--num-gpus N`` (or ``num_devices`` in the config) trains on N ranks, one
process per GPU spawned by `parallel.dist.launch`, rank r on ``cuda:r``;
under ``torchrun`` each process joins the group the environment describes
instead. The backend is NCCL on GPUs and gloo on the CPU, unless the
config names ``dist_backend``. ``--device`` puts every rank on the device
it names: ``--device cpu --num-gpus 2`` trains two gloo ranks on the CPU.
Without ``--device`` it runs on the GPU, and raises when there is none.
`main(argv)` takes the arguments as a list and returns the trainer after
its run, or None when it spawned the ranks.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional

from cdsegnet_torch.engine.config import Config, parse_options
from cdsegnet_torch.engine.train import TRAINERS
from cdsegnet_torch.parallel import dist
from cdsegnet_torch.utils.device import resolve_device


def main(argv: Optional[List[str]] = None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config-file", required=True)
    ap.add_argument("--options", nargs="*", default=None, help="key=value overrides")
    ap.add_argument("--num-gpus", type=int, default=None,
                    help="ranks to train on (default: the config's num_devices, or 1)")
    ap.add_argument("--device", default=None, help="torch device (default: the GPU)")
    argv = list(sys.argv[1:] if argv is None else argv)
    args = ap.parse_args(argv)
    cfg = Config.fromfile(args.config_file)
    cfg.merge_from_dict(parse_options(args.options))
    backend = cfg.get("dist_backend")
    torchrun = dist.init_from_env(args.device, backend)
    try:
        if dist.is_initialized():
            cfg.num_devices = dist.world_size()
            device = dist.rank_device(args.device)
        else:
            cfg.num_devices = args.num_gpus or cfg.get("num_devices") or 1
            device = resolve_device(args.device)
            if cfg.num_devices > 1:
                dist.launch(rank_main, cfg.num_devices, args=(argv,), backend=backend,
                            device=args.device)
                return None
        save_path = cfg.get("save_path", "exp/default")
        if dist.is_main():
            os.makedirs(save_path, exist_ok=True)
            cfg.dump(os.path.join(save_path, "config.py"))
        trainer = TRAINERS.build(dict(cfg.get("train", dict(type="DefaultTrainer"))),
                                 cfg=cfg, device=device)
        trainer.train()
        return trainer
    finally:
        if torchrun:
            dist.destroy()


def rank_main(argv: Optional[List[str]]) -> None:
    """One spawned rank: `main` inside the process group `launch` built."""
    main(argv)


if __name__ == "__main__":
    main()
