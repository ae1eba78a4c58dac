"""Logging: a Python logger and TensorBoard scalars; counterpart of
heltondetection_tpu/utils/log.py. ``TBWriter`` does nothing when
``torch.utils.tensorboard`` cannot be imported."""

from __future__ import annotations

import logging
import os
import sys
from typing import Dict, Optional

LOGGER = "heltondetection_tpu_torch"


def get_logger(name: str = LOGGER,
               log_file: Optional[str] = None) -> logging.Logger:
    """The package logger, to stdout, and to ``log_file`` when given: the
    file belongs to the current run, so a second run in one process logs
    into its own file, not the first run's."""
    logger = logging.getLogger(name)
    fmt = logging.Formatter(
        "%(asctime)s %(levelname)s %(name)s: %(message)s", "%H:%M:%S")
    if not any(type(h) is logging.StreamHandler for h in logger.handlers):
        sh = logging.StreamHandler(sys.stdout)
        sh.setFormatter(fmt)
        logger.addHandler(sh)
        logger.propagate = False
    if logger.level == logging.NOTSET:
        logger.setLevel(logging.INFO)
    if log_file:
        path = os.path.abspath(log_file)
        stale = [h for h in logger.handlers
                 if isinstance(h, logging.FileHandler)
                 and h.baseFilename != path]
        for h in stale:
            logger.removeHandler(h)
            h.close()
        if not any(isinstance(h, logging.FileHandler)
                   and h.baseFilename == path for h in logger.handlers):
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            fh = logging.FileHandler(path)
            fh.setFormatter(fmt)
            logger.addHandler(fh)
    return logger


class TBWriter:
    """A thin TensorBoard scalar writer; does nothing when TensorBoard is
    not installed."""

    def __init__(self, log_dir: Optional[str]):
        self._w = None
        if log_dir:
            try:
                from torch.utils.tensorboard import SummaryWriter
                self._w = SummaryWriter(log_dir)
            except ImportError:
                self._w = None

    def scalars(self, step: int, values: Dict[str, float],
                prefix: str = "") -> None:
        if self._w is None:
            return
        for k, v in values.items():
            try:
                self._w.add_scalar(f"{prefix}{k}", float(v), step)
            except (TypeError, ValueError):
                pass

    def close(self):
        if self._w is not None:
            self._w.close()
