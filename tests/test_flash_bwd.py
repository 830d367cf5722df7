"""FA2 backward kernels vs oracle — the framework's "stage 02_bwd" ladder.

Keeps the reference's two-case structure: a simple hand-scale case
(ref: 02_bwd/main.cu:51-189, seq=4 d=4 scale=1, gate 1e-3) and a complex
random case (ref: :195-309, seq=128 d=64, gate 5e-3), plus cases the
reference lacks (causal, GQA, non-divisible, bf16, jax.grad end-to-end).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cuda_flashattention_tpu.ops.attention import flash_attention
from cuda_flashattention_tpu.ops.common import BlockSizes
from cuda_flashattention_tpu.ops.flash_bwd import flash_attention_backward
from cuda_flashattention_tpu.ops.flash_fwd import flash_attention_forward
from cuda_flashattention_tpu.ops.naive import (
    naive_attention,
    naive_attention_backward,
)
from cuda_flashattention_tpu.utils.testing import (
    assert_close,
    random_qkv,
    seeded_random,
)


# Backward tiles under test: the default and small ones, which give
# every program masked edges, unmasked middles and padded tails.
TILES = {"default": None, "small": BlockSizes(block_q_bwd=16,
                                              block_k_bwd=32)}


def _check_grads(q, k, v, tol, causal=False, kv_offset=0, scale=None,
                 block_sizes=None):
    do = jnp.asarray(seeded_random(q.shape, 99))
    o, lse = flash_attention_forward(
        q, k, v, scale=scale, causal=causal, kv_offset=kv_offset,
        block_sizes=block_sizes)
    dq, dk, dv = flash_attention_backward(
        q, k, v, o, lse, do, scale=scale, causal=causal,
        kv_offset=kv_offset, block_sizes=block_sizes)
    dq_r, dk_r, dv_r = naive_attention_backward(
        q, k, v, do, scale=scale, causal=causal, kv_offset=kv_offset)
    assert_close(dq, dq_r, tol, "dQ")
    assert_close(dk, dk_r, tol, "dK")
    assert_close(dv, dv_r, tol, "dV")


def test_simple_4x4():
    # (ref: 02_bwd/main.cu:51-189 — seq=4, d=4, scale=1, gate 1e-3)
    q, k, v = random_qkv(1, 1, 4, 4, 4)
    _check_grads(q, k, v, tol=1e-3, scale=1.0)


def test_complex_128x64():
    # (ref: 02_bwd/main.cu:195-309 — seq=128, d=64, random ±0.5, gate 5e-3)
    q, k, v = random_qkv(1, 1, 128, 128, 64)
    _check_grads(q, k, v, tol=5e-3)


@pytest.mark.parametrize("tiles", list(TILES))
def test_multihead(tiles):
    q, k, v = random_qkv(2, 3, 192, 256, 64)
    _check_grads(q, k, v, tol=5e-3, block_sizes=TILES[tiles])


@pytest.mark.parametrize("tiles", list(TILES))
def test_causal(tiles):
    q, k, v = random_qkv(1, 2, 160, 160, 64)
    _check_grads(q, k, v, tol=5e-3, causal=True, block_sizes=TILES[tiles])


@pytest.mark.parametrize("tiles", list(TILES))
def test_causal_kv_offset(tiles):
    q, k, v = random_qkv(1, 1, 64, 192, 32)
    _check_grads(q, k, v, tol=5e-3, causal=True, kv_offset=128,
                 block_sizes=TILES[tiles])


@pytest.mark.parametrize("nq,nk", [(100, 72), (65, 130)])
@pytest.mark.parametrize("tiles", list(TILES))
def test_non_divisible(nq, nk, tiles):
    q, k, v = random_qkv(1, 1, nq, nk, 32)
    _check_grads(q, k, v, tol=5e-3, block_sizes=TILES[tiles])


@pytest.mark.parametrize("bq,bk", [(8, 8), (32, 64)])
@pytest.mark.parametrize("causal", [False, True])
def test_block_sweep(bq, bk, causal):
    q, k, v = random_qkv(1, 1, 96, 96, 32)
    _check_grads(q, k, v, tol=5e-3, causal=causal,
                 block_sizes=BlockSizes(block_q_bwd=bq, block_k_bwd=bk))


@pytest.mark.parametrize("kw", [dict(), dict(causal=True),
                                dict(causal=True, window=64),
                                dict(causal=True, kv_offset=64)],
                         ids=["full", "causal", "window", "offset"])
def test_split_backward_all_masks(kw):
    """Both backward kernels across every masking feature with GQA, at
    small tiles so the dK/dV kernel's query-tile range and the dQ
    kernel's KV-tile range both have masked edges."""
    q, _, _ = random_qkv(2, 4, 200, 200, 32)
    _, k, v = random_qkv(2, 2, 200, 200, 32, seed=5)
    do = jnp.asarray(seeded_random(q.shape, 99))
    bs = BlockSizes(block_q_bwd=32, block_k_bwd=16)
    o, lse = flash_attention_forward(q, k, v, **kw)
    dq, dk, dv = flash_attention_backward(q, k, v, o, lse, do,
                                          block_sizes=bs, **kw)
    dq_r, dk_f, dv_f = naive_attention_backward(
        q, jnp.repeat(k, 2, 1), jnp.repeat(v, 2, 1), do, **kw)
    assert_close(dq, dq_r, 5e-3, f"dQ {kw}")
    assert_close(dk, dk_f.reshape(2, 2, 2, 200, 32).sum(2), 5e-3, f"dK {kw}")
    assert_close(dv, dv_f.reshape(2, 2, 2, 200, 32).sum(2), 5e-3, f"dV {kw}")


def test_segments_backward():
    q, k, v = random_qkv(1, 2, 96, 96, 32)
    qseg = jnp.asarray(
        np.repeat(np.arange(3), 32)[None, :], jnp.int32)
    o, lse = flash_attention_forward(
        q, k, v, q_segment_ids=qseg, kv_segment_ids=qseg)
    do = jnp.asarray(seeded_random(q.shape, 7))
    kw = dict(q_segment_ids=qseg, kv_segment_ids=qseg)
    got = flash_attention_backward(
        q, k, v, o, lse, do, block_sizes=BlockSizes(block_q_bwd=16,
                                                     block_k_bwd=16), **kw)
    ref = naive_attention_backward(q, k, v, do, **kw)
    for a, b_, name in zip(got, ref, ("dQ", "dK", "dV")):
        assert_close(a, b_, 5e-3, f"segmented {name}")


def test_jax_grad_end_to_end():
    """flash_attention is a custom_vjp op: jax.grad must agree with the
    oracle's gradients (the reference has no autodiff — its tests call
    fwd/bwd separately; ours compose)."""
    q, k, v = random_qkv(1, 2, 128, 128, 64)
    do = jnp.asarray(seeded_random(q.shape, 42))

    dq, dk, dv = jax.grad(
        lambda q, k, v: jnp.vdot(flash_attention(q, k, v, causal=True), do),
        argnums=(0, 1, 2))(q, k, v)
    dq_r, dk_r, dv_r = naive_attention_backward(q, k, v, do, causal=True)
    assert_close(dq, dq_r, 5e-3, "dQ")
    assert_close(dk, dk_r, 5e-3, "dK")
    assert_close(dv, dv_r, 5e-3, "dV")


def test_jax_grad_gqa():
    q, _, _ = random_qkv(1, 4, 64, 64, 32)
    _, k, v = random_qkv(1, 2, 64, 64, 32, seed=3)
    do = jnp.asarray(seeded_random(q.shape, 17))

    dq, dk, dv = jax.grad(
        lambda q, k, v: jnp.vdot(flash_attention(q, k, v), do),
        argnums=(0, 1, 2))(q, k, v)

    k_full, v_full = jnp.repeat(k, 2, 1), jnp.repeat(v, 2, 1)
    dq_r, dk_full, dv_full = naive_attention_backward(q, k_full, v_full, do)
    dk_r = dk_full.reshape(1, 2, 2, 64, 32).sum(axis=2)
    dv_r = dv_full.reshape(1, 2, 2, 64, 32).sum(axis=2)
    assert_close(dq, dq_r, 5e-3, "dQ")
    assert_close(dk, dk_r, 5e-3, "dK")
    assert_close(dv, dv_r, 5e-3, "dV")


def test_bf16_grads():
    q, k, v = random_qkv(1, 1, 128, 128, 64, dtype=jnp.bfloat16)
    do = jnp.asarray(seeded_random(q.shape, 23), jnp.bfloat16)
    dq, dk, dv = jax.grad(
        lambda q, k, v: jnp.vdot(
            flash_attention(q, k, v).astype(jnp.float32),
            do.astype(jnp.float32)),
        argnums=(0, 1, 2))(q, k, v)
    assert dq.dtype == jnp.bfloat16
    dq_r, dk_r, dv_r = naive_attention_backward(q, k, v, do)
    assert_close(dq.astype(jnp.float32), dq_r, 3e-2, "dQ (bf16)")
    assert_close(dk.astype(jnp.float32), dk_r, 3e-2, "dK (bf16)")
    assert_close(dv.astype(jnp.float32), dv_r, 3e-2, "dV (bf16)")


def test_gqa_backward_no_repeat():
    """Grouped dK/dV kernel vs the oracle with explicitly repeated heads
    (each dK/dV program loops over its group's query heads; nothing is
    repeated)."""
    import jax
    import jax.numpy as jnp
    from cuda_flashattention_tpu.ops.attention import flash_attention
    from cuda_flashattention_tpu.ops.naive import naive_attention_backward
    from cuda_flashattention_tpu.utils.testing import assert_close, seeded_random

    b, h, h_kv, n, d = 2, 8, 2, 96, 32
    q = jnp.asarray(seeded_random((b, h, n, d), seed=61))
    k = jnp.asarray(seeded_random((b, h_kv, n, d), seed=62))
    v = jnp.asarray(seeded_random((b, h_kv, n, d), seed=63))
    do = jnp.asarray(seeded_random((b, h, n, d), seed=64))

    def loss(q, k, v):
        return jnp.sum(flash_attention(q, k, v, causal=True) * do)

    dq, dk, dv = jax.grad(loss, argnums=(0, 1, 2))(q, k, v)

    group = h // h_kv
    k_full = jnp.repeat(k, group, axis=1)
    v_full = jnp.repeat(v, group, axis=1)
    dq_r, dk_r, dv_r = naive_attention_backward(q, k_full, v_full, do,
                                                causal=True)
    dk_ref = dk_r.reshape(b, h_kv, group, n, d).sum(axis=2)
    dv_ref = dv_r.reshape(b, h_kv, group, n, d).sum(axis=2)
    tol = 2e-3
    assert_close(dq, dq_r, tol, name="gqa dQ")
    assert_close(dk, dk_ref, tol, name="gqa dK")
    assert_close(dv, dv_ref, tol, name="gqa dV")
