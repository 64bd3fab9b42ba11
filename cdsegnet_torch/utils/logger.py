"""Rank-aware file+console logger (own copy of `cdsegnet_tpu/utils/logger.py`)."""

from __future__ import annotations

import logging
import os
import sys
from typing import Optional

_LOGGERS = {}


def get_root_logger(
    log_file: Optional[str] = None,
    name: str = "cdsegnet_torch",
    level: int = logging.INFO,
    rank: int = 0,
) -> logging.Logger:
    if name in _LOGGERS:
        return _LOGGERS[name]
    logger = logging.getLogger(name)
    logger.setLevel(level if rank == 0 else logging.ERROR)
    logger.propagate = False
    fmt = logging.Formatter(
        "[%(asctime)s %(levelname)s %(filename)s:%(lineno)d] %(message)s"
    )
    sh = logging.StreamHandler(sys.stdout)
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if log_file and rank == 0:
        os.makedirs(os.path.dirname(os.path.abspath(log_file)), exist_ok=True)
        fh = logging.FileHandler(log_file)
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    _LOGGERS[name] = logger
    return logger
