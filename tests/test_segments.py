"""Packed-sequence (segment-ids) masking tests — fwd, bwd, and the
packing invariant: attention over packed segments must equal attention
over each segment in isolation. Capability beyond the reference (which
has no masking at all, SURVEY.md §2.3)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from cuda_flashattention_tpu.ops.attention import flash_attention
from cuda_flashattention_tpu.ops.flash_fwd import flash_attention_forward
from cuda_flashattention_tpu.ops.naive import (
    naive_attention,
    naive_attention_backward,
)
from cuda_flashattention_tpu.utils.testing import assert_close, seeded_random

# fp32 inputs: the kernels run fp32 dots at full precision
_STOL = 1e-3
_STOL_G = 2e-3


def make_segs(b, n, sizes):
    assert sum(sizes) == n
    ids = np.concatenate([np.full(s, i) for i, s in enumerate(sizes)])
    return jnp.asarray(np.tile(ids, (b, 1)), jnp.int32)


@pytest.mark.parametrize("causal", [False, True])
def test_segments_fwd_vs_oracle(causal):
    b, h, n, d = 2, 2, 48, 16
    q = jnp.asarray(seeded_random((b, h, n, d), seed=81))
    k = jnp.asarray(seeded_random((b, h, n, d), seed=82))
    v = jnp.asarray(seeded_random((b, h, n, d), seed=83))
    seg = make_segs(b, n, [8, 16, 24])
    o, lse = flash_attention_forward(
        q, k, v, causal=causal, q_segment_ids=seg, kv_segment_ids=seg)
    r, rl = naive_attention(q, k, v, causal=causal, q_segment_ids=seg,
                            kv_segment_ids=seg)
    assert_close(o, r, _STOL, name=f"seg fwd causal={causal}")
    fin = jnp.isfinite(rl)
    assert_close(lse[fin], rl[fin], _STOL, name="seg lse")


@pytest.mark.parametrize("causal", [False, True])
def test_segments_grad_vs_oracle(causal):
    b, h, n, d = 1, 2, 40, 16
    q = jnp.asarray(seeded_random((b, h, n, d), seed=84))
    k = jnp.asarray(seeded_random((b, h, n, d), seed=85))
    v = jnp.asarray(seeded_random((b, h, n, d), seed=86))
    do = jnp.asarray(seeded_random((b, h, n, d), seed=87))
    seg = make_segs(b, n, [16, 24])

    def loss(q, k, v):
        o = flash_attention(q, k, v, causal=causal, q_segment_ids=seg,
                            kv_segment_ids=seg)
        return jnp.sum(o.astype(jnp.float32) * do)

    dq, dk, dv = jax.grad(loss, argnums=(0, 1, 2))(q, k, v)
    dq_r, dk_r, dv_r = naive_attention_backward(
        q, k, v, do, causal=causal, q_segment_ids=seg, kv_segment_ids=seg)
    assert_close(dq, dq_r, _STOL_G, name="seg dQ")
    assert_close(dk, dk_r, _STOL_G, name="seg dK")
    assert_close(dv, dv_r, _STOL_G, name="seg dV")


def test_packing_invariant():
    """Two sequences packed into one row with segment ids == each run
    separately (causal)."""
    b, h, d = 1, 2, 16
    n1, n2 = 24, 16
    q = jnp.asarray(seeded_random((b, h, n1 + n2, d), seed=91))
    k = jnp.asarray(seeded_random((b, h, n1 + n2, d), seed=92))
    v = jnp.asarray(seeded_random((b, h, n1 + n2, d), seed=93))
    seg = make_segs(b, n1 + n2, [n1, n2])
    o_packed, _ = flash_attention_forward(
        q, k, v, causal=True, q_segment_ids=seg, kv_segment_ids=seg)
    o1, _ = flash_attention_forward(q[:, :, :n1], k[:, :, :n1],
                                    v[:, :, :n1], causal=True)
    o2, _ = flash_attention_forward(q[:, :, n1:], k[:, :, n1:],
                                    v[:, :, n1:], causal=True)
    assert_close(o_packed[:, :, :n1], o1, 1e-5, name="packed seg 1")
    assert_close(o_packed[:, :, n1:], o2, 1e-5, name="packed seg 2")


def test_cross_segment_is_fully_masked():
    """Disjoint q/kv segment ids: every pair masked → O=0, LSE=-inf."""
    b, h, n, d = 1, 1, 16, 16
    q = jnp.asarray(seeded_random((b, h, n, d), seed=94))
    k = jnp.asarray(seeded_random((b, h, n, d), seed=95))
    v = jnp.asarray(seeded_random((b, h, n, d), seed=96))
    qs = jnp.zeros((b, n), jnp.int32)
    ks = jnp.ones((b, n), jnp.int32)
    o, lse = flash_attention_forward(q, k, v, q_segment_ids=qs,
                                     kv_segment_ids=ks)
    assert float(jnp.max(jnp.abs(o))) == 0.0
    assert bool((lse < -1e29).all())
