"""Shared bootstrap for the example ladder.

The reference's ladder stages are self-verifying mains launched by
mpirun/Modal (ref: src/03_flash_attention_v2_ring/*.cu, scripts/modal_mpi.py).
Here each stage is a plain python script; multi-"rank" execution comes from
either (a) a virtual 8-device CPU mesh in ONE process (default — the cheap
CI substitute the reference lacks), (b) the GPUs of the host when
JAX_PLATFORMS names one (e.g. JAX_PLATFORMS=cuda), or (c) REAL multiple
processes over jax.distributed when launched via
scripts/launch_multihost.py (the mpirun equivalent; coordinator/rank
arrive in CFA_* env vars).

On the CPU the Pallas kernels run in the interpreter, which this module
opts into (CFA_PALLAS_INTERPRET=1); on a GPU they compile.

Import this module BEFORE importing jax anywhere in an example: the
virtual-device flag must be set before the XLA backend initialises.
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from cuda_flashattention_tpu import config  # imports no jax — safe here

_ON_CPU = os.environ.get("JAX_PLATFORMS", "cpu") in ("", "cpu")
_MULTIPROC = bool(config.COORD())

if _ON_CPU:
    os.environ["CFA_PALLAS_INTERPRET"] = "1"
    if not _MULTIPROC:
        # one process, N virtual CPU devices
        n = config.VIRTUAL_DEVICES()
        flags = os.environ.get("XLA_FLAGS", "")
        if "host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags + f" --xla_force_host_platform_device_count={n}"
            ).strip()

import jax  # noqa: E402

from cuda_flashattention_tpu.utils.compile_cache import (  # noqa: E402
    enable_compile_cache)

if _ON_CPU:
    jax.config.update("jax_platforms", "cpu")
enable_compile_cache()


def bootstrap():
    """Initialise distributed execution if launched multi-process
    (the `init_mpi_nccl` equivalent, ref: nccl_utils.h:68-93); return
    (process_id, device list)."""
    if _MULTIPROC:
        from cuda_flashattention_tpu.parallel.mesh import (
            initialize_distributed)
        initialize_distributed(
            coordinator_address=config.COORD(),
            num_processes=config.NPROC.as_int,
            process_id=config.PID.as_int,
        )
    return jax.process_index(), jax.devices()


def report(name: str, passed: bool) -> int:
    """The reference's PASS/FAIL contract, greppable by
    scripts/test_examples.sh (ref: scripts/test_examples.sh:36-46 greps
    "Test Pass"; the inverted-branch quirk of 00_mpi_vecadd.cu:131-137 is
    deliberately not reproduced)."""
    if jax.process_index() == 0:
        print(f"[{name}] {'Test PASSED!' if passed else 'Test FAILED!'}")
    return 0 if passed else 1
