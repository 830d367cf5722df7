"""Paged attention tests: a paged layout with a shuffled page table must
reproduce contiguous decode exactly."""

import numpy as np
import jax.numpy as jnp
import pytest

from cuda_flashattention_tpu.ops.decode import decode_attention
from cuda_flashattention_tpu.ops.naive import naive_attention
from cuda_flashattention_tpu.ops.paged import paged_decode_attention
from cuda_flashattention_tpu.ops.quant import quantize_kv
from cuda_flashattention_tpu.utils.testing import assert_close, seeded_random

B, H, HKV, D = 2, 4, 2, 16
PAGE = 16
MAX_PAGES = 6

# fp32 inputs: the kernels' fp32 dots run at full precision
_PTOL = 1e-4


def paginate(k, v, lengths, rng):
    """Scatter the LIVE prefix of contiguous [B,Hkv,N,d] caches into a
    shuffled page pool: only ceil(length/PAGE) pages per row hold real
    data — everything else (spare pages, junk table entries, the tail of
    the last live page) is garbage the kernel must mask/ignore."""
    b, hkv, n, d = k.shape
    total = b * MAX_PAGES + 3
    order = rng.permutation(total)
    k_pool = np.asarray(
        rng.uniform(-9, 9, (total, hkv, PAGE, d)), np.float32)
    v_pool = k_pool.copy()[::-1].reshape(total, hkv, PAGE, d).copy()
    table = np.zeros((b, MAX_PAGES), np.int32)
    slot = 0
    for i in range(b):
        live_pages = -(-int(lengths[i]) // PAGE)
        for p in range(MAX_PAGES):
            if p < live_pages:
                pid = int(order[slot]); slot += 1
                table[i, p] = pid
                lo = p * PAGE
                hi = min(int(lengths[i]), lo + PAGE)
                k_pool[pid, :, :hi - lo] = np.asarray(k[i, :, lo:hi])
                v_pool[pid, :, :hi - lo] = np.asarray(v[i, :, lo:hi])
            else:
                table[i, p] = int(order[slot - 1])  # junk entry, ignored
    return (jnp.asarray(k_pool), jnp.asarray(v_pool), jnp.asarray(table))


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(7)
    n = PAGE * 4
    q = jnp.asarray(seeded_random((B, H, D), seed=201))
    k = jnp.asarray(seeded_random((B, HKV, n, D), seed=202))
    v = jnp.asarray(seeded_random((B, HKV, n, D), seed=203))
    return rng, q, k, v


def test_paged_matches_contiguous(setup):
    rng, q, k, v = setup
    lengths = jnp.asarray([PAGE * 4, PAGE * 2 + 5], jnp.int32)
    k_pool, v_pool, table = paginate(k, v, lengths, rng)
    o_p, lse_p = paged_decode_attention(q, k_pool, v_pool, table, lengths)
    o_c, lse_c = decode_attention(q, k, v, lengths, block_k=PAGE)
    assert_close(o_p, o_c, 1e-5, name="paged vs contiguous O")
    assert_close(lse_p, lse_c, 1e-5, name="paged vs contiguous LSE")


def test_paged_vs_oracle(setup):
    rng, q, k, v = setup
    lengths = jnp.asarray([37, 61], jnp.int32)
    k_pool, v_pool, table = paginate(k, v, lengths, rng)
    o_p, _ = paged_decode_attention(q, k_pool, v_pool, table, lengths)
    kf = jnp.repeat(k, H // HKV, axis=1)
    vf = jnp.repeat(v, H // HKV, axis=1)
    for i, ln in enumerate([37, 61]):
        r, _ = naive_attention(q[i:i+1, :, None], kf[i:i+1, :, :ln],
                               vf[i:i+1, :, :ln])
        assert_close(o_p[i:i+1], r[:, :, 0], _PTOL, name=f"paged oracle {i}")


@pytest.mark.parametrize("qtype", ["int8", "fp8", "mixed"])
def test_paged_quantized(setup, qtype):
    rng, q, k, v = setup
    n = k.shape[2]
    lengths = jnp.asarray([n, n - 11], jnp.int32)
    kv = quantize_kv(k, v, qtype)
    # paginate the quantized values and their scales with the same table
    k_pool, v_pool, table = paginate(
        kv.k_q.astype(jnp.float32), kv.v_q.astype(jnp.float32),
        lengths, np.random.default_rng(7))
    k_pool = k_pool.astype(kv.k_q.dtype)
    v_pool = v_pool.astype(kv.v_q.dtype)
    ks_pool, vs_pool, _ = paginate(
        kv.k_scale[..., None], kv.v_scale[..., None], lengths,
        np.random.default_rng(7))
    o_p, _ = paged_decode_attention(
        q, k_pool, v_pool, table, lengths,
        k_scale=ks_pool[..., 0], v_scale=vs_pool[..., 0])
    o_c, _ = decode_attention(q, kv.k_q, kv.v_q, lengths,
                              k_scale=kv.k_scale, v_scale=kv.v_scale)
    # paged (page=16) and contiguous (block=128) accumulate in different
    # tilings
    tol = 1e-4
    assert_close(o_p, o_c, tol, name=f"paged {qtype}")


def test_paged_cache_lifecycle():
    """End-to-end serving lifecycle: interleaved appends across two
    sequences through the allocator, attention matching a contiguous
    shadow cache each step, then page release + reuse."""
    from cuda_flashattention_tpu.ops.paged import (
        PageAllocator, init_paged_cache, paged_append, paged_decode_step)

    b, hkv, h, page, maxp, d = 2, 2, 2, 8, 4, 16
    cache = init_paged_cache(n_pages=10, batch=b, max_pages=maxp,
                             heads_kv=hkv, page_size=page, d=d,
                             dtype=jnp.float32)
    alloc = PageAllocator(10)
    rng = np.random.default_rng(5)
    shadow_k = np.zeros((b, hkv, page * maxp, d), np.float32)
    shadow_v = np.zeros_like(shadow_k)

    n_steps = 19  # crosses two page boundaries
    for t in range(n_steps):
        k_new = jnp.asarray(rng.uniform(-1, 1, (b, hkv, d)), jnp.float32)
        v_new = jnp.asarray(rng.uniform(-1, 1, (b, hkv, d)), jnp.float32)
        for i in range(b):
            cache = alloc.reserve_for(cache, i, 1)
        cache = paged_append(cache, k_new, v_new)
        shadow_k[:, :, t] = np.asarray(k_new)
        shadow_v[:, :, t] = np.asarray(v_new)

        if t in (0, 7, 8, 15, 18):
            q = jnp.asarray(rng.uniform(-1, 1, (b, h, d)), jnp.float32)
            o, _ = paged_decode_step(q, cache)
            lengths = jnp.full((b,), t + 1, jnp.int32)
            o_ref, _ = decode_attention(q, jnp.asarray(shadow_k),
                                        jnp.asarray(shadow_v), lengths,
                                        block_k=page)
            assert_close(o, o_ref, 1e-5, name=f"lifecycle t={t}")

    # release sequence 0 and verify its pages get reused
    free_before = len(alloc.free)
    cache = alloc.release_sequence(cache, 0)
    assert len(alloc.free) == free_before + 3  # ceil(19/8) pages freed
    cache = alloc.reserve_for(cache, 0, 1)
    assert len(alloc.free) == free_before + 2


@pytest.mark.parametrize("qtype", ["int8", "fp8", "mixed"])
def test_paged_cache_quantized_lifecycle(qtype):
    """Covers the pool-allocation + per-ARRAY append quantisation path:
    a "mixed" pool must come up int8-K/fp8-V and appends must quantize
    each array onto ITS OWN grid (review r3: one shared qtype derived
    from k_pages.dtype double-quantized V through the wrong grid)."""
    from cuda_flashattention_tpu.ops.paged import (
        PageAllocator, init_paged_cache, paged_append, paged_decode_step)
    from cuda_flashattention_tpu.ops.naive import naive_attention

    b, hkv, h, page, maxp, d = 1, 2, 4, 8, 3, 16
    cache = init_paged_cache(n_pages=6, batch=b, max_pages=maxp,
                             heads_kv=hkv, page_size=page, d=d,
                             qtype=qtype)
    want_k = jnp.int8 if qtype in ("int8", "mixed") else jnp.float8_e4m3fn
    want_v = jnp.int8 if qtype == "int8" else jnp.float8_e4m3fn
    assert cache.k_pages.dtype == want_k
    assert cache.v_pages.dtype == want_v
    alloc = PageAllocator(6)
    rng = np.random.default_rng(6)
    ks, vs = [], []
    for t in range(11):
        k_new = jnp.asarray(rng.uniform(-1, 1, (b, hkv, d)), jnp.float32)
        v_new = jnp.asarray(rng.uniform(-1, 1, (b, hkv, d)), jnp.float32)
        cache = alloc.reserve_for(cache, 0, 1)
        cache = paged_append(cache, k_new, v_new)
        ks.append(np.asarray(k_new))
        vs.append(np.asarray(v_new))
    q = jnp.asarray(rng.uniform(-1, 1, (b, h, d)), jnp.float32)
    o, _ = paged_decode_step(q, cache)
    kf = jnp.repeat(jnp.asarray(np.stack(ks, 2)), h // hkv, 1)
    vf = jnp.repeat(jnp.asarray(np.stack(vs, 2)), h // hkv, 1)
    r, _ = naive_attention(q[:, :, None], kf, vf)
    # int8 gate 5e-3; e4m3 V (fp8/mixed) has a ~3%-relative grid, so 2e-2
    # (the module-wide fp8 accuracy gate) — still far under the >=6%
    # signature of a double-quantized (int8-codes-through-e4m3) V pool.
    tol = 5e-3 if qtype == "int8" else 2e-2
    assert_close(o, r[:, :, 0], tol, name=f"quantized lifecycle {qtype}")


def test_allocator_capacity_and_leak_guard():
    """Regressions from review: (a) exceeding table capacity must raise,
    not silently corrupt live pages; (b) a multi-token reservation that
    crosses a page boundary must not leak its page when fewer tokens
    arrive before the next reserve."""
    from cuda_flashattention_tpu.ops.paged import (
        PageAllocator, init_paged_cache, paged_append)
    b, hkv, page, maxp, d = 1, 1, 4, 2, 8  # capacity: 8 tokens
    cache = init_paged_cache(n_pages=8, batch=b, max_pages=maxp,
                             heads_kv=hkv, page_size=page, d=d,
                             dtype=jnp.float32)
    alloc = PageAllocator(8)

    # (b) leak guard: reserve 2 tokens at length 3 (allocates page slot 1),
    # append only one, reserve again — slot 1 must NOT be re-allocated
    for _ in range(3):
        cache = alloc.reserve_for(cache, 0, 1)
        cache = paged_append(cache, jnp.zeros((b, hkv, d)),
                             jnp.zeros((b, hkv, d)))
    free0 = len(alloc.free)
    cache = alloc.reserve_for(cache, 0, 2)   # crosses into page 1
    assert len(alloc.free) == free0 - 1
    cache = paged_append(cache, jnp.zeros((b, hkv, d)),
                         jnp.zeros((b, hkv, d)))  # only 1 of the 2
    cache = alloc.reserve_for(cache, 0, 1)   # must reuse slot 1
    assert len(alloc.free) == free0 - 1, "page leaked on re-reserve"

    # (a) capacity: grow to 8 (full), then one more must raise
    for _ in range(4):
        cache = alloc.reserve_for(cache, 0, 1)
        cache = paged_append(cache, jnp.zeros((b, hkv, d)),
                             jnp.zeros((b, hkv, d)))
    assert int(cache.lengths[0]) == 8
    with pytest.raises(ValueError):
        alloc.reserve_for(cache, 0, 1)

    # release returns ALL assigned pages (both slots)
    n_free_before = len(alloc.free)
    cache = alloc.release_sequence(cache, 0)
    assert len(alloc.free) == n_free_before + 2


def test_paged_prefill_flow():
    """Paged chunked-prefill building blocks: page-aligned bulk appends
    of prompt chunks, then a chunk of queries attending the paged prefix
    + itself causally (log-space combine) == contiguous causal attention
    over the whole prompt."""
    from cuda_flashattention_tpu.ops.flash_fwd import flash_attention_forward
    from cuda_flashattention_tpu.ops.paged import (
        PageAllocator, init_paged_cache, paged_bulk_append,
        paged_prefix_attention)
    from cuda_flashattention_tpu.parallel.ring import combine_partials

    b, hkv, h, page, maxp, d = 2, 2, 4, 16, 4, 16
    chunk = 32  # 2 pages per chunk — page-aligned
    rng = np.random.default_rng(9)
    n = 2 * chunk
    q_all = jnp.asarray(rng.uniform(-1, 1, (b, h, n, d)), jnp.float32)
    k_all = jnp.asarray(rng.uniform(-1, 1, (b, hkv, n, d)), jnp.float32)
    v_all = jnp.asarray(rng.uniform(-1, 1, (b, hkv, n, d)), jnp.float32)

    cache = init_paged_cache(n_pages=12, batch=b, max_pages=maxp,
                             heads_kv=hkv, page_size=page, d=d,
                             dtype=jnp.float32)
    alloc = PageAllocator(12)
    outs = []
    for s in range(0, n, chunk):
        qc = q_all[:, :, s:s + chunk]
        kc = k_all[:, :, s:s + chunk]
        vc = v_all[:, :, s:s + chunk]
        # chunk self-attention (local causal)
        o_new, lse_new = flash_attention_forward(
            qc, kc, vc, causal=True, out_dtype=jnp.float32)
        if s > 0:
            o_old, lse_old = paged_prefix_attention(qc, cache)
            o_c, _ = combine_partials(o_old.astype(jnp.float32),
                                      lse_old, o_new, lse_new)
        else:
            o_c = o_new
        outs.append(o_c)
        for i in range(b):
            cache = alloc.reserve_for(cache, i, chunk)
        cache = paged_bulk_append(cache, kc, vc)

    o_paged = jnp.concatenate(outs, axis=2)
    kf = jnp.repeat(k_all, h // hkv, 1)
    vf = jnp.repeat(v_all, h // hkv, 1)
    o_ref, _ = flash_attention_forward(q_all, kf, vf, causal=True,
                                       out_dtype=jnp.float32)
    assert_close(o_paged, o_ref, _PTOL, name="paged chunked prefill")


def test_allocator_pool_exhaustion_no_leak():
    """reserve_for must pre-check the free list: a mid-reservation
    failure must not strand already-popped pages (ADVICE r1)."""
    from cuda_flashattention_tpu.ops.paged import (
        PageAllocator, init_paged_cache)
    cache = init_paged_cache(n_pages=2, batch=1, max_pages=8, heads_kv=1,
                             page_size=2, d=8, dtype=jnp.float32)
    alloc = PageAllocator(2)
    n_free = len(alloc.free)
    with pytest.raises(RuntimeError, match="exhausted"):
        alloc.reserve_for(cache, 0, 6)  # needs 3 pages, pool has 2
    assert len(alloc.free) == n_free, "pages leaked by failed reserve"


def test_bulk_append_alignment_guard():
    """paged_bulk_append must reject non-page-aligned write heads when
    lengths are host-visible (ADVICE r1): a misaligned start would write
    at offset 0 of the base page, clobbering live tokens."""
    from cuda_flashattention_tpu.ops.paged import (
        PageAllocator, init_paged_cache, paged_append, paged_bulk_append)
    b, hkv, page, d = 1, 1, 4, 8
    cache = init_paged_cache(n_pages=8, batch=b, max_pages=4, heads_kv=hkv,
                             page_size=page, d=d, dtype=jnp.float32)
    alloc = PageAllocator(8)
    cache = alloc.reserve_for(cache, 0, 1)
    cache = paged_append(cache, jnp.zeros((b, hkv, d)),
                         jnp.zeros((b, hkv, d)))  # length now 1: unaligned
    chunk = jnp.zeros((b, hkv, page, d), jnp.float32)
    with pytest.raises(ValueError, match="page-aligned"):
        paged_bulk_append(cache, chunk, chunk)


def test_paged_window(setup):
    """Sliding-window paged decode vs the windowed oracle (the window/
    windows support shipped untested — ADVICE r2). Mirrors
    test_decode_windows_exceeding_static_cap: a static window sizes the
    O(window) page grid and hard-caps per-seq dynamic windows."""
    rng, q, k, v = setup
    n = k.shape[2]
    lengths = jnp.asarray([n, n - 11], jnp.int32)
    k_pool, v_pool, table = paginate(k, v, lengths, rng)
    kf = jnp.repeat(k, H // HKV, axis=1)
    vf = jnp.repeat(v, H // HKV, axis=1)
    win = PAGE * 2
    o_w, _ = paged_decode_attention(q, k_pool, v_pool, table, lengths,
                                    window=win)
    for i in range(B):
        ln = int(lengths[i])
        r, _ = naive_attention(q[i:i + 1, :, None],
                               kf[i:i + 1, :, ln - win:ln],
                               vf[i:i + 1, :, ln - win:ln])
        assert_close(o_w[i:i + 1], r[:, :, 0], _PTOL,
                     name=f"paged window {i}")
    # per-seq dynamic windows above the static cap must be capped
    o_c, _ = paged_decode_attention(
        q, k_pool, v_pool, table, lengths, window=win,
        windows=jnp.asarray([n, win // 2], jnp.int32))
    for i, w_eff in enumerate([win, win // 2]):
        ln = int(lengths[i])
        r, _ = naive_attention(q[i:i + 1, :, None],
                               kf[i:i + 1, :, ln - w_eff:ln],
                               vf[i:i + 1, :, ln - w_eff:ln])
        assert_close(o_c[i:i + 1], r[:, :, 0], _PTOL,
                     name=f"paged capped dynamic window {i}")
    # dynamic windows WITHOUT a static cap keep the full grid
    o_d, _ = paged_decode_attention(
        q, k_pool, v_pool, table, lengths,
        windows=jnp.asarray([win, n], jnp.int32))
    for i, w_eff in enumerate([win, int(lengths[1])]):
        ln = int(lengths[i])
        r, _ = naive_attention(q[i:i + 1, :, None],
                               kf[i:i + 1, :, ln - w_eff:ln],
                               vf[i:i + 1, :, ln - w_eff:ln])
        assert_close(o_d[i:i + 1], r[:, :, 0], _PTOL,
                     name=f"paged uncapped dynamic window {i}")


def test_paged_fp8_bf16_q(setup):
    """bf16 q + fp8 pages: the per-array shift-cast flags engage (no
    paged test used bf16 q before — ADVICE r2)."""
    rng, q, k, v = setup
    n = k.shape[2]
    q16, k16, v16 = (q.astype(jnp.bfloat16), k.astype(jnp.bfloat16),
                     v.astype(jnp.bfloat16))
    kv = quantize_kv(k16, v16, "fp8")
    lengths = jnp.asarray([n, n - 11], jnp.int32)
    k_pool, v_pool, table = paginate(
        kv.k_q.astype(jnp.float32), kv.v_q.astype(jnp.float32),
        lengths, np.random.default_rng(7))
    k_pool = k_pool.astype(kv.k_q.dtype)
    v_pool = v_pool.astype(kv.v_q.dtype)
    ks_pool, vs_pool, _ = paginate(
        kv.k_scale[..., None], kv.v_scale[..., None], lengths,
        np.random.default_rng(7))
    o_p, _ = paged_decode_attention(
        q16, k_pool, v_pool, table, lengths,
        k_scale=ks_pool[..., 0], v_scale=vs_pool[..., 0])
    o_c, _ = decode_attention(q16, kv.k_q, kv.v_q, lengths,
                              k_scale=kv.k_scale, v_scale=kv.v_scale)
    tol = 1e-3
    assert_close(o_p.astype(jnp.float32), o_c.astype(jnp.float32), tol,
                 name="paged fp8 bf16-q")


def test_paged_decode_step_forwards_window():
    """paged_decode_step must forward window/windows to
    paged_decode_attention (review r4: the convenience wrapper silently
    dropped them, so windowed serving through it attended the WHOLE
    cache)."""
    from cuda_flashattention_tpu.ops.paged import (
        PageAllocator, init_paged_cache, paged_bulk_append,
        paged_decode_step)
    from cuda_flashattention_tpu.ops.naive import naive_attention

    rng = np.random.default_rng(17)
    b, hkv, h, d, page, n = 1, 2, 2, 32, 64, 256
    k = jnp.asarray(rng.uniform(-0.5, 0.5, (b, hkv, n, d)), jnp.float32)
    v = jnp.asarray(rng.uniform(-0.5, 0.5, (b, hkv, n, d)), jnp.float32)
    # poison the out-of-window prefix: if the window is dropped, these
    # huge values leak into the output and the compare fails loudly
    k = k.at[:, :, : n - 64].set(1e3)
    q = jnp.asarray(rng.uniform(-0.5, 0.5, (b, h, d)), jnp.float32)
    cache = init_paged_cache(n_pages=8, batch=b, max_pages=4,
                             heads_kv=hkv, page_size=page, d=d,
                             dtype=jnp.float32)
    alloc = PageAllocator(8)
    cache = alloc.reserve_for(cache, 0, n)
    cache = paged_bulk_append(cache, k, v)
    o, _ = paged_decode_step(q, cache, window=64)
    o_ref, _ = naive_attention(q[:, :, None, :], k[:, :, n - 64:],
                               v[:, :, n - 64:])
    assert_close(o, o_ref[:, :, 0], _PTOL, name="paged_decode_step window")
