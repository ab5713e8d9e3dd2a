"""Leveled logging (the reference's observability is bare ``printf`` to stdout —
SURVEY.md §5; here we route the same diagnostics through ``logging`` with a
framework-wide namespace so callers can silence or capture them).

Port copy of ``ehyb_spmv_gpu_tpu/utils/log.py``: the machine with the GPU has no
JAX, so the host layer lives in both packages.  Keep the two in step.
"""
from __future__ import annotations

import logging
import os

_ROOT = "ehyb_torch"
_configured = False


def get_logger(name: str = "") -> logging.Logger:
    global _configured
    if not _configured:
        level = os.environ.get("EHYB_LOG", "INFO").upper()
        logging.basicConfig(
            format="%(asctime)s %(name)s %(levelname)s %(message)s")
        logging.getLogger(_ROOT).setLevel(level)
        _configured = True
    short = name.replace("ehyb_spmv_torch", _ROOT) if name else _ROOT
    return logging.getLogger(short)
