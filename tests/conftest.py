"""Test configuration: CPU with a virtual 8-device mesh, kernels in the
Pallas interpreter.

The reference tests on real multi-GPU via Modal cloud (ref:
scripts/modal_mpi.py:29-59); here the multi-device paths run on a virtual
8-device CPU mesh (`--xla_force_host_platform_device_count=8`) and the
Pallas kernels run in interpret mode, which this file opts into
(CFA_PALLAS_INTERPRET=1; without it a kernel call off the GPU raises).

Tests that need the card carry the `gpu` marker (pyproject.toml) and are
skipped by the fixture below unless the backend is a GPU. Run them on
the card with JAX_PLATFORMS=cuda (this file then leaves the platform
alone): `JAX_PLATFORMS=cuda python -m pytest -m gpu tests/`.
"""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

ON_CPU = os.environ.get("JAX_PLATFORMS", "cpu") == "cpu"
if ON_CPU:
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=8"
    )
    os.environ["CFA_PALLAS_INTERPRET"] = "1"

import jax  # noqa: E402

if ON_CPU:
    jax.config.update("jax_platforms", "cpu")


@pytest.fixture(autouse=True)
def _skip_gpu_tests_off_the_card(request):
    if (request.node.get_closest_marker("gpu") is not None
            and jax.default_backend() != "gpu"):
        pytest.skip("needs a GPU: run with JAX_PLATFORMS=cuda on the card")
