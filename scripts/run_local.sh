#!/usr/bin/env bash
# Local (CPU, no GPU needed) test driver — counterpart of the reference's
# local runners (ref: scripts/local_gpu.sh, scripts/local_mpi.sh). Pallas
# kernels run in interpreter mode; multi-chip paths run on a virtual
# 8-device CPU mesh (tests/conftest.py sets this up).
set -euo pipefail
cd "$(dirname "$0")/.."
python -m pytest tests/ -q "$@"
