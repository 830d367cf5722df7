"""Framework configuration — the env-knob registry.

Counterpart of the reference's configuration surface, which is spread
over env vars (NCCL_DEBUG, OMPI_MCA_*, ref: scripts/modal_mpi.py:14-17),
shell vars (N_GPU, ref: 03 run.sh:2) and compile-time template params.
Here every runtime knob is an environment variable with one definition,
a default, and a docstring; kernel tile sizes stay runtime arguments
(ops.common.BlockSizes / the autotuner), not env state.

    from cuda_flashattention_tpu import config
    if config.PALLAS_INTERPRET.as_bool:
        ...
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict


@dataclasses.dataclass(frozen=True)
class Knob:
    name: str
    default: str
    doc: str

    def __call__(self) -> str:
        return os.environ.get(self.name, self.default)

    @property
    def as_bool(self) -> bool:
        return self() == "1"

    @property
    def as_int(self) -> int:
        return int(self())


PALLAS_INTERPRET = Knob(
    "CFA_PALLAS_INTERPRET", "0",
    "1 → off the GPU, run the Pallas kernels in the interpreter "
    "(tests/conftest.py and the CPU examples set it). Without it a "
    "kernel call off the GPU raises; on the GPU kernels always compile.")

VIRTUAL_DEVICES = Knob(
    "CFA_VIRTUAL_DEVICES", "8",
    "Virtual CPU device count for single-process mesh runs "
    "(examples/_common.py; tests/conftest.py uses 8).")

LOG_LEVEL = Knob(
    "CFA_LOG_LEVEL", "INFO",
    "Log level for the framework logger (utils/log.py).")

LOG_ALL_PROCS = Knob(
    "CFA_LOG_ALL_PROCS", "0",
    "1 → every process logs; default only process 0 (utils/log.py — the "
    "reference's rank-0-prints convention).")

AUTOTUNE_CACHE = Knob(
    "CFA_AUTOTUNE_CACHE",
    os.path.join(os.path.expanduser("~"), ".cache", "cfa",
                 "autotune.json"),
    "On-disk cache for measured block sizes (utils/autotune.py).")

NATIVE_CACHE = Knob(
    "CFA_NATIVE_CACHE",
    os.path.join(os.path.expanduser("~"), ".cache", "cfa"),
    "Build cache dir for the native C++ oracle (runtime/native.py).")

# Multi-process launch (set by scripts/launch_multihost.py — the mpirun
# equivalent; read by examples/_common.bootstrap):
COORD = Knob("CFA_COORD", "", "Coordinator address host:port.")
NPROC = Knob("CFA_NPROC", "1", "Total process count.")
PID = Knob("CFA_PID", "0", "This process's id.")


def all_knobs() -> Dict[str, Knob]:
    return {k: v for k, v in globals().items() if isinstance(v, Knob)}


def describe() -> str:
    lines = []
    for name, knob in sorted(all_knobs().items()):
        cur = knob()
        mark = "" if cur == knob.default else f"  (set: {cur!r})"
        lines.append(f"{knob.name:24s} default={knob.default!r}{mark}\n"
                     f"    {knob.doc}")
    return "\n".join(lines)


if __name__ == "__main__":
    print(describe())
