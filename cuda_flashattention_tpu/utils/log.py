"""Structured, process-prefixed logging.

Counterpart of the reference's rank-prefixed progress prints
(ref: ring_attention_kernel.cu:201-202 prints "[Rank %d] step %d ...";
colorized monitor output in scripts/monitor_gpu.py). Every record is
prefixed `[pN]` with the jax process index so interleaved multi-host
output stays attributable — the jax.distributed analog of MPI rank tags.

    from cuda_flashattention_tpu.utils.log import get_logger
    log = get_logger(__name__)
    log.info("ring step %d: kv block %d", step, kv_idx)

Knobs: CFA_LOG_LEVEL (default INFO), CFA_LOG_ALL_PROCS=1 to log from
every process (default: process 0 only, the reference's rank-0-prints
convention for results, ref: 04_ring_attention.cu:129-143).
"""

from __future__ import annotations

import logging
import os
import sys
from typing import Optional

_CONFIGURED = False


class _ProcessFilter(logging.Filter):
    def filter(self, record: logging.LogRecord) -> bool:
        from cuda_flashattention_tpu import config
        if config.LOG_ALL_PROCS.as_bool:
            return True
        return _process_index() == 0


def _process_index() -> int:
    try:
        import jax
        return jax.process_index()
    except Exception:
        return 0


class _ProcessFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        record.proc = _process_index()
        return super().format(record)


class _StderrHandler(logging.StreamHandler):
    """StreamHandler that resolves sys.stderr AT EMIT TIME.

    Binding the stream at configure time pins whatever object sys.stderr
    was when the FIRST get_logger() ran — under pytest's capsys (or any
    stderr redirection installed later) records then bypass the
    redirect. Same pattern as logging's lastResort handler."""

    def __init__(self) -> None:
        logging.Handler.__init__(self)

    @property
    def stream(self):
        return sys.stderr

    @stream.setter
    def stream(self, value):
        raise AttributeError(
            "_StderrHandler resolves sys.stderr at emit time; "
            "setStream()/stream assignment is unsupported — redirect "
            "sys.stderr itself instead.")


def _configure() -> None:
    global _CONFIGURED
    if _CONFIGURED:
        return
    handler = _StderrHandler()
    handler.setFormatter(_ProcessFormatter(
        "[p%(proc)d] %(asctime)s %(levelname)s %(name)s: %(message)s",
        datefmt="%H:%M:%S"))
    handler.addFilter(_ProcessFilter())
    from cuda_flashattention_tpu import config
    root = logging.getLogger("cuda_flashattention_tpu")
    root.addHandler(handler)
    root.setLevel(config.LOG_LEVEL().upper())
    root.propagate = False
    _CONFIGURED = True


def get_logger(name: Optional[str] = None) -> logging.Logger:
    _configure()
    base = "cuda_flashattention_tpu"
    if name and not name.startswith(base):
        name = f"{base}.{name}"
    return logging.getLogger(name or base)
