"""Logging: single-process SPMD replaces rank-0-gated prints.

The reference gates output on MPI rank 0 (std_out_all_processes=False,
common.py:21-23; ``if rank == 0`` in every demo). Under JAX SPMD there is one
Python process per host; for multi-host meshes only process 0 logs.
"""
from __future__ import annotations

import logging
import sys

import jax

_logger = logging.getLogger("iifea")
if not _logger.handlers:
    h = logging.StreamHandler(sys.stdout)
    h.setFormatter(logging.Formatter("%(message)s"))
    _logger.addHandler(h)
    _logger.setLevel(logging.INFO)


def is_lead_process() -> bool:
    try:
        return jax.process_index() == 0
    except Exception:
        return True


def log_info(msg: str) -> None:
    if is_lead_process():
        _logger.info(msg)
        sys.stdout.flush()
