"""Structured logging.

A copy of ``hybrid9_tpu/utils/logging.py`` for the port's loggers (under
``hybrid9_tpu_torch``): it replaces the reference's unstructured
``WRITE(*,*)`` progress lines (e.g. INIT.f90:44,476; HYBRID9.f90:509,571)
with standard Python logging, one logger per module, tagged with the
process rank under a multi-process launch (``RANK``).
"""

from __future__ import annotations

import logging
import os
import sys

ROOT = "hybrid9_tpu_torch"


def get_logger(name: str) -> logging.Logger:
    logger = logging.getLogger(name)
    root = logging.getLogger(ROOT)
    if not root.handlers:
        handler = logging.StreamHandler(sys.stderr)
        rank = os.environ.get("RANK", "0")
        handler.setFormatter(logging.Formatter(
            f"%(asctime)s [h9torch r{rank}] %(levelname)s %(name)s: "
            "%(message)s", datefmt="%H:%M:%S"))
        root.addHandler(handler)
        root.setLevel(os.environ.get("H9TPU_LOGLEVEL", "INFO"))
    return logger
