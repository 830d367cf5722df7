"""FA2 forward kernel vs oracle — the framework's "stage 02_fwd" ladder.

Keeps the reference's fixture ladder (SURVEY.md §4): tiny hand-checkable
cases, seeded random at the reference's exact shapes (512x64, ref:
02_fwd/main.cu:14-33), block-size sweeps (ref: 01/main.cu:342-344), and
non-divisible edge sizes.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from cuda_flashattention_tpu.ops.common import BlockSizes
from cuda_flashattention_tpu.ops.flash_fwd import flash_attention_forward
from cuda_flashattention_tpu.ops.naive import naive_attention
from cuda_flashattention_tpu.utils.testing import (
    assert_close,
    identity_qk_fixture,
    random_qkv,
)

def _run(q, k, v, tol=5e-3, lse_tol=1e-2, **kw):
    o, lse = flash_attention_forward(q, k, v, **kw)
    o_ref, lse_ref = naive_attention(
        q, k, v, scale=kw.get("scale"), causal=kw.get("causal", False),
        kv_offset=kw.get("kv_offset", 0))
    assert_close(o, o_ref, tol, "O")
    assert_close(lse, lse_ref, lse_tol, "LSE")


def test_identity_4x4():
    # (ref: 02_fwd/main.cu:115-262 test_simple_attention, 4x4, scale=1)
    q, k, v = identity_qk_fixture(4, 4)
    _run(q[None, None], k[None, None], v[None, None], tol=1e-3, scale=1.0)


def test_reference_shape_512x64():
    # (ref: 02_fwd/main.cu:12-112 — seq=512, d=64, pass gate 5e-3 at :89)
    q, k, v = random_qkv(1, 1, 512, 512, 64)
    _run(q, k, v, tol=5e-3)


def test_multihead_batched():
    q, k, v = random_qkv(2, 4, 256, 384, 64)
    _run(q, k, v, tol=5e-3)


@pytest.mark.parametrize("block_q,block_k", [(8, 8), (16, 32), (64, 128),
                                             (128, 64)])
def test_block_size_sweep(block_q, block_k):
    # Same case at several tile sizes to shake tiling bugs
    # (ref: 01/main.cu:342-344 runs Bc ∈ {1,2,4}).
    q, k, v = random_qkv(1, 2, 160, 160, 64)
    _run(q, k, v, tol=5e-3,
         block_sizes=BlockSizes(block_q=block_q, block_k=block_k))


@pytest.mark.parametrize("nq,nk", [(3, 5), (100, 64), (257, 129), (64, 1)])
def test_non_divisible_shapes(nq, nk):
    # The reference asserts divisibility (ref: 04_ring_attention.cu:56-63);
    # we must mask instead (SURVEY.md §7 hard part (e)).
    q, k, v = random_qkv(1, 1, nq, nk, 32)
    _run(q, k, v, tol=5e-3)


def test_causal():
    q, k, v = random_qkv(1, 2, 200, 200, 64)
    _run(q, k, v, tol=5e-3, causal=True)


def test_causal_kv_offset():
    # Sequence-sharded caller: this Q shard starts at global row 128.
    q, k, v = random_qkv(1, 2, 64, 192, 64)
    _run(q, k, v, tol=5e-3, causal=True, kv_offset=128)


def test_causal_fully_masked_rows():
    # kv_offset < 0 makes early rows see nothing; their output must be 0.
    q, k, v = random_qkv(1, 1, 32, 32, 32)
    o, lse = flash_attention_forward(q, k, v, causal=True, kv_offset=-8)
    assert np.all(np.asarray(o[0, 0, :8]) == 0.0)
    o_ref, _ = naive_attention(q, k, v, causal=True, kv_offset=-8)
    assert_close(o[:, :, 8:], o_ref[:, :, 8:], 5e-3, "O")


def test_gqa():
    q, _, _ = random_qkv(2, 8, 128, 128, 64)
    _, k, v = random_qkv(2, 2, 128, 128, 64, seed=5)
    o, _ = flash_attention_forward(q, k, v)
    o_ref, _ = naive_attention(q, jnp.repeat(k, 4, 1), jnp.repeat(v, 4, 1))
    assert_close(o, o_ref, 5e-3, "O (GQA)")


def test_bf16_inputs():
    q, k, v = random_qkv(1, 2, 256, 256, 64, dtype=jnp.bfloat16)
    o, _ = flash_attention_forward(q, k, v)
    assert o.dtype == jnp.bfloat16
    o_ref, _ = naive_attention(q, k, v)
    assert_close(o.astype(jnp.float32), o_ref, 2e-2, "O (bf16)")


def test_scale_override():
    q, k, v = random_qkv(1, 1, 64, 64, 32)
    _run(q, k, v, tol=5e-3, scale=1.0)


def _oracle(q, k, v, **kw):
    group = q.shape[1] // k.shape[1]
    return naive_attention(q, jnp.repeat(k, group, 1),
                           jnp.repeat(v, group, 1), **kw)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("mask", ["full", "causal", "window"])
@pytest.mark.parametrize("group", [1, 4])
def test_forward_grid(dtype, mask, group):
    """The Triton forward across dtype × mask × GQA, at a ragged length
    and small tiles so every program sees masked edges, an unmasked
    middle and a padded tail."""
    h = 4
    q, _, _ = random_qkv(1, h, 150, 150, 32, dtype=dtype)
    _, k, v = random_qkv(1, h // group, 150, 150, 32, dtype=dtype, seed=3)
    kw = dict(causal=mask != "full", window=40 if mask == "window" else 0)
    o, lse = flash_attention_forward(
        q, k, v, block_sizes=BlockSizes(block_q=32, block_k=16), **kw)
    o_ref, lse_ref = _oracle(q, k, v, **kw)
    tol = 5e-3 if dtype == jnp.float32 else 2e-2
    assert_close(o.astype(jnp.float32), o_ref, tol, f"O {mask} g={group}")
    assert_close(lse, lse_ref, tol, f"LSE {mask} g={group}")


@pytest.mark.parametrize("nq,nk,kv_offset", [(48, 112, 64), (37, 70, 33),
                                             (100, 100, 0)])
def test_ragged_kv_offset(nq, nk, kv_offset):
    """A query shard starting `kv_offset` rows into a ragged key range."""
    q, k, v = random_qkv(1, 2, nq, nk, 16)
    for window in (0, 24):
        o, lse = flash_attention_forward(
            q, k, v, causal=True, window=window, kv_offset=kv_offset,
            block_sizes=BlockSizes(block_q=16, block_k=32))
        o_ref, lse_ref = naive_attention(q, k, v, causal=True,
                                         window=window, kv_offset=kv_offset)
        assert_close(o, o_ref, 5e-3, f"O window={window}")
        visible = np.asarray(lse_ref) > -1e29
        assert_close(np.where(visible, lse, 0), np.where(visible, lse_ref, 0),
                     5e-3, f"LSE window={window}")


@pytest.mark.parametrize("qtype", ["int8", "fp8", "mixed"])
@pytest.mark.parametrize("causal", [False, True])
def test_quantized_kv_forward(qtype, causal):
    """int8 / fp8 / mixed K-V loaded in storage dtype, dequantized by
    their per-token scales in-kernel: equal to the kernel on the
    dequantized values."""
    from cuda_flashattention_tpu.ops.quant import quantize_kv
    q, k, v = random_qkv(1, 2, 70, 90, 32)
    kv = quantize_kv(k, v, qtype)
    o, lse = flash_attention_forward(
        q, kv.k_q, kv.v_q, k_scale=kv.k_scale, v_scale=kv.v_scale,
        causal=causal, block_sizes=BlockSizes(block_q=32, block_k=32))
    k_dq, v_dq = kv.dequantize()
    o_ref, lse_ref = naive_attention(q, k_dq, v_dq, causal=causal)
    assert_close(o, o_ref, 1e-4, f"O {qtype}")
    assert_close(lse, lse_ref, 1e-4, f"LSE {qtype}")


def test_segments_forward_grid():
    """Packed segments with GQA and a ragged tail: every tile masked."""
    q, _, _ = random_qkv(1, 4, 90, 90, 16)
    _, k, v = random_qkv(1, 2, 90, 90, 16, seed=7)
    seg = jnp.asarray(np.repeat([0, 1, 2], [20, 45, 25])[None], jnp.int32)
    o, _ = flash_attention_forward(
        q, k, v, causal=True, q_segment_ids=seg, kv_segment_ids=seg,
        block_sizes=BlockSizes(block_q=16, block_k=16))
    o_ref, _ = _oracle(q, k, v, causal=True, q_segment_ids=seg,
                       kv_segment_ids=seg)
    assert_close(o, o_ref, 5e-3, "O segments")


@pytest.mark.parametrize("d", [4, 24, 128])
def test_head_dim_padding(d):
    """Head dims that are not a legal Triton tile width are zero-padded
    by the wrapper and sliced back."""
    q, k, v = random_qkv(1, 1, 40, 40, d)
    o, lse = flash_attention_forward(q, k, v, causal=True)
    assert o.shape == q.shape and lse.shape == q.shape[:3]
    o_ref, _ = naive_attention(q, k, v, causal=True)
    assert_close(o, o_ref, 5e-3, f"O d={d}")
