#!/usr/bin/env bash
# Ladder stage selector — counterpart of the reference's run.sh
# (ref: src/03_flash_attention_v2_ring/run.sh:10-27 maps ./run.sh [0-4] to
# one Modal function per stage). Stages run on a virtual 8-device CPU mesh
# by default; set JAX_PLATFORMS=cuda to run them on the host's GPUs, or
# use scripts/launch_multihost.py for real multi-process execution.
#
# Usage: ./scripts/run_ladder.sh [0|1|2|3|4|5|6|all]
set -euo pipefail
cd "$(dirname "$0")/.."

stage="${1:-all}"
declare -a STAGES=(
  "examples/00_psum_vecadd.py"
  "examples/01_ppermute_verify.py"
  "examples/02_overlap.py"
  "examples/03_attention_1chip.py"
  "examples/04_ring_attention.py"
  "examples/05_generate.py"
  "examples/06_paged_serving.py"
)

run_stage() {
  echo "=== ladder stage: $1 ==="
  python "$1"
}

if [[ "$stage" == "all" ]]; then
  for s in "${STAGES[@]}"; do run_stage "$s"; done
else
  run_stage "${STAGES[$stage]}"
fi
