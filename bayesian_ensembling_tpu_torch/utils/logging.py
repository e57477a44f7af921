"""Structured logging seam.

From ``bayesian_ensembling_tpu/utils/logging.py`` (pure Python): one
configurable logger for the package.
"""

from __future__ import annotations

import logging
import sys

__all__ = ["get_logger"]

_FORMAT = "%(asctime)s %(name)s %(levelname)s %(message)s"


def get_logger(name: str = "bayesian_ensembling_tpu_torch",
               level: int = logging.INFO) -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter(_FORMAT))
        logger.addHandler(handler)
        logger.setLevel(level)
        logger.propagate = False
    return logger

