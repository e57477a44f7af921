"""Structured logging seam.

Copy of ``bayesian_ensembling_tpu/utils/logging.py`` (pure Python): one
configurable logger for the package plus a one-line metrics helper.
"""

from __future__ import annotations

import logging
import sys
import typing as tp

__all__ = ["get_logger", "log_metrics"]

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


def log_metrics(metrics: tp.Mapping[str, float], prefix: str = "", logger=None) -> None:
    logger = logger or get_logger()
    body = " ".join(f"{k}={v:.6g}" for k, v in metrics.items())
    logger.info("%s%s", f"{prefix} " if prefix else "", body)
