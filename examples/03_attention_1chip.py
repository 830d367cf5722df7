"""Ladder stage 03 — single-chip FA2 vs naive oracle at ring scale.

Counterpart of the reference's rank-0 sanity stage
(ref: src/03_flash_attention_v2_ring/03_attention_1GPU.cu:9-100): before
going distributed, prove the single-device kernel at the exact shape the
ring test will use — seq=5096 (deliberately not tile-divisible), d=64,
scale=1.0 (:17-21). The reference broadcasts the oracle to all ranks; with
a replicated jax array that is implicit.
"""

import _common  # noqa: F401

import sys

import jax.numpy as jnp

from cuda_flashattention_tpu.ops.flash_fwd import flash_attention_forward
from cuda_flashattention_tpu.ops.naive import naive_attention
from cuda_flashattention_tpu.utils.testing import (
    compare_outputs,
    seeded_random,
)

# seq is the reference shape by default; CI shrinks it via env
SEQ = int(__import__("os").environ.get("CFA_LADDER_SEQ", "5096"))
D, SCALE = 64, 1.0


def main() -> int:
    _common.bootstrap()
    q = jnp.asarray(seeded_random((1, 1, SEQ, D), seed=42)) * 0.1
    k = jnp.asarray(seeded_random((1, 1, SEQ, D), seed=43)) * 0.1
    v = jnp.asarray(seeded_random((1, 1, SEQ, D), seed=44))

    o, _ = flash_attention_forward(q, k, v, scale=SCALE)
    o_ref, _ = naive_attention(q, k, v, scale=SCALE)

    # ref gate: rtol 5e-3 / atol 1.0 via compare_outputs
    # (ref: attention_helper.h:174-208)
    ok = compare_outputs(o, o_ref, rtol=5e-3, atol=1e-3,
                         name="fa2 vs naive @5096x64")
    return _common.report("03_attention_1chip", ok)


if __name__ == "__main__":
    sys.exit(main())
