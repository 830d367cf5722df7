"""Paged attention: decode over non-contiguous KV pages (block tables).

Production serving allocates KV cache in fixed-size PAGES shared by all
sequences (vLLM-style) instead of one contiguous strip per sequence —
no fragmentation, instant reuse, and sequence-length-independent
allocation. No reference analog (the CUDA ladder has no serving layer):

  * the page pool is one array [n_pages, Hkv, page_size, d] (plus
    per-token scale pools when quantized),
  * each sequence's logical cache is a row of `page_table`
    [B, max_pages] holding physical page ids,
  * decode gathers each sequence's pages through its table row into a
    contiguous [B, Hkv, max_pages·page_size, d] view with `jnp.take` and
    runs the contiguous decode kernel (ops/decode.py) on it; pages past
    a sequence's length are gathered but never attended.

The paged cache is off the model's path today, so the gather copy is
plain XLA rather than a kernel of its own.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from cuda_flashattention_tpu.ops.decode import decode_attention


def _gather_pages(pool: jnp.ndarray, table: jnp.ndarray) -> jnp.ndarray:
    """pool [n_pages, Hkv, page_size, ...] gathered through table
    [B, max_pages] into [B, Hkv, max_pages·page_size, ...]."""
    g = jnp.take(pool, table, axis=0)    # [B, max_pages, Hkv, ps, ...]
    g = jnp.moveaxis(g, 2, 1)            # [B, Hkv, max_pages, ps, ...]
    return g.reshape(g.shape[:2] + (-1,) + g.shape[4:])


@functools.partial(jax.jit, static_argnames=("scale", "window"))
def paged_decode_attention(
    q: jnp.ndarray,
    k_pages: jnp.ndarray,
    v_pages: jnp.ndarray,
    page_table: jnp.ndarray,
    lengths: jnp.ndarray,
    k_scale: Optional[jnp.ndarray] = None,
    v_scale: Optional[jnp.ndarray] = None,
    scale: Optional[float] = None,
    window: int = 0,
    windows: Optional[jnp.ndarray] = None,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """One decode step over paged caches.

    q [B,H,d]; k_pages/v_pages [n_pages, Hkv, page_size, d] (the shared
    pool); page_table [B, max_pages] int32 physical page ids (entries
    beyond a sequence's ceil(length/page_size) pages are ignored);
    lengths [B] int32 live token counts. Optional per-token scale pools
    [n_pages, Hkv, page_size] for int8/fp8 storage.

    `window`/`windows` restrict attention to the last `window` live
    tokens exactly as in ops/decode.py::decode_attention.

    Returns (o [B,H,d], lse [B,H]).
    """
    b = q.shape[0]
    n_pool, h_kv, page_size, _ = k_pages.shape
    if (k_scale is None) != (v_scale is None):
        raise ValueError("k_scale and v_scale go together")
    table = jnp.asarray(page_table, jnp.int32).reshape(b, -1)
    scales = {}
    if k_scale is not None:
        for name, sc in (("k_scale", k_scale), ("v_scale", v_scale)):
            if sc.shape != (n_pool, h_kv, page_size):
                raise ValueError(
                    f"scale pool shape {sc.shape} != "
                    f"{(n_pool, h_kv, page_size)}")
            scales[name] = _gather_pages(sc, table)
    return decode_attention(
        q, _gather_pages(k_pages, table), _gather_pages(v_pages, table),
        jnp.asarray(lengths, jnp.int32).reshape(b), scale=scale,
        window=window, windows=windows, **scales)


# ---------------------------------------------------------------------------
# Paged cache management: pool + block tables + host-side page allocator
# ---------------------------------------------------------------------------


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class PagedKVCache:
    """Paged KV cache for one attention layer.

    k_pages/v_pages: [n_pages, Hkv, page_size, d] shared pools (storage
    dtype bf16/f32/int8/fp8). k_scale/v_scale: [n_pages, Hkv, page_size]
    fp32 pools or None. page_table: [B, max_pages] int32 physical ids.
    lengths: [B] int32 live tokens per sequence.
    """

    k_pages: jnp.ndarray
    v_pages: jnp.ndarray
    k_scale: Optional[jnp.ndarray]
    v_scale: Optional[jnp.ndarray]
    page_table: jnp.ndarray
    lengths: jnp.ndarray

    @property
    def page_size(self) -> int:
        return self.k_pages.shape[2]

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None


class PageAllocator:
    """Host-side free-list page allocator (the serving driver runs this
    OUTSIDE jit, like every block-table system): hand out physical page
    ids as sequences grow, reclaim them when sequences finish.

    Tracks per-sequence assigned-slot high-water marks so multi-token
    reservations are never re-allocated (and hence leaked) when fewer
    tokens were appended than reserved."""

    def __init__(self, n_pages: int):
        self.free = list(range(n_pages - 1, -1, -1))
        self._assigned: dict = {}  # batch_idx -> table slots allocated

    def alloc(self) -> int:
        if not self.free:
            raise RuntimeError("page pool exhausted")
        return self.free.pop()

    def release(self, page_ids) -> None:
        self.free.extend(int(p) for p in page_ids)

    def reserve_for(self, cache: PagedKVCache, batch_idx: int,
                    new_tokens: int = 1) -> PagedKVCache:
        """Ensure sequence `batch_idx` has pages for `new_tokens` more
        tokens, allocating and writing table entries as needed. Raises
        when the sequence would exceed max_pages*page_size capacity
        (an out-of-bounds table write would be silently dropped by JAX
        and the clamped append would corrupt a live page)."""
        ps = cache.page_size
        max_pages = cache.page_table.shape[1]
        have = int(cache.lengths[batch_idx])
        pages_now = max(-(-have // ps) if have else 0,
                        self._assigned.get(batch_idx, 0))
        pages_need = max(pages_now, -(-(have + new_tokens) // ps))
        if pages_need > max_pages:
            raise ValueError(
                f"sequence {batch_idx} needs {pages_need} pages for "
                f"{have + new_tokens} tokens but the table holds only "
                f"{max_pages} (capacity {max_pages * ps} tokens)")
        if pages_need - pages_now > len(self.free):
            # pre-check so a mid-reservation failure can't strand pages
            # in a discarded table copy (they'd leave the free list but
            # never be recorded anywhere reclaimable)
            raise RuntimeError(
                f"page pool exhausted: sequence {batch_idx} needs "
                f"{pages_need - pages_now} more pages, {len(self.free)} "
                f"free")
        table = cache.page_table
        for p in range(pages_now, pages_need):
            table = table.at[batch_idx, p].set(self.alloc())
        self._assigned[batch_idx] = pages_need
        return dataclasses.replace(cache, page_table=table)

    def release_sequence(self, cache: PagedKVCache,
                         batch_idx: int) -> PagedKVCache:
        """Free all pages of a finished sequence (including reserved-but-
        unfilled slots)."""
        ps = cache.page_size
        n = max(-(-int(cache.lengths[batch_idx]) // ps),
                self._assigned.get(batch_idx, 0))
        self.release(np.asarray(cache.page_table[batch_idx, :n]))
        self._assigned[batch_idx] = 0
        return dataclasses.replace(
            cache, lengths=cache.lengths.at[batch_idx].set(0))


def init_paged_cache(n_pages: int, batch: int, max_pages: int,
                     heads_kv: int, page_size: int, d: int,
                     qtype: Optional[str] = None,
                     dtype=jnp.bfloat16) -> PagedKVCache:
    from cuda_flashattention_tpu.ops.quant import _pair_qtypes, _storage_dtype
    if qtype:
        kt, vt = _pair_qtypes(qtype)  # "mixed" -> int8 K pool / fp8 V pool
        k_store, v_store = _storage_dtype(kt), _storage_dtype(vt)
    else:
        k_store = v_store = dtype
    shape = (n_pages, heads_kv, page_size, d)
    sshape = (n_pages, heads_kv, page_size)
    # distinct buffers (no aliased arrays — donation safety, see kv_cache)
    return PagedKVCache(
        jnp.zeros(shape, k_store), jnp.zeros(shape, v_store),
        jnp.ones(sshape, jnp.float32) if qtype else None,
        jnp.ones(sshape, jnp.float32) if qtype else None,
        jnp.zeros((batch, max_pages), jnp.int32),
        jnp.zeros((batch,), jnp.int32))


def paged_append(cache: PagedKVCache, k_new: jnp.ndarray,
                 v_new: jnp.ndarray) -> PagedKVCache:
    """Append ONE token per sequence (k/v [B, Hkv, d]) at each write
    head. The caller must have reserved pages (PageAllocator.reserve_for).
    Quantizes at append when the pools are quantized. Jit-compatible
    (page ids are data, positions are dynamic)."""
    from cuda_flashattention_tpu.ops.quant import quantize_tensor
    b = k_new.shape[0]
    ps = cache.page_size
    # one batched scatter per pool (not B serial dynamic_update_slices):
    # pids/offs are [B] vectors, .at[pids, :, offs] lowers to lax.scatter
    pids = cache.page_table[jnp.arange(b), cache.lengths // ps]
    offs = cache.lengths % ps
    k_pages, v_pages = cache.k_pages, cache.v_pages
    ks_pool, vs_pool = cache.k_scale, cache.v_scale
    if cache.quantized:
        # per-ARRAY qtype: a "mixed" pool (int8 K / fp8 V) must quantize
        # each array onto its own grid — int8 codes written through an
        # fp8 cast silently double-quantize (codes > 16 are not exactly
        # representable in e4m3).
        kt = "int8" if k_pages.dtype == jnp.int8 else "fp8"
        vt = "int8" if v_pages.dtype == jnp.int8 else "fp8"
        kq, ks = quantize_tensor(k_new[:, :, None, :], kt)  # [B,H,1,d]
        vq, vs = quantize_tensor(v_new[:, :, None, :], vt)
        k_pages = k_pages.at[pids, :, offs].set(
            kq[:, :, 0].astype(k_pages.dtype))
        v_pages = v_pages.at[pids, :, offs].set(
            vq[:, :, 0].astype(v_pages.dtype))
        ks_pool = ks_pool.at[pids, :, offs].set(ks[:, :, 0])
        vs_pool = vs_pool.at[pids, :, offs].set(vs[:, :, 0])
    else:
        k_pages = k_pages.at[pids, :, offs].set(
            k_new.astype(k_pages.dtype))
        v_pages = v_pages.at[pids, :, offs].set(
            v_new.astype(v_pages.dtype))
    return dataclasses.replace(
        cache, k_pages=k_pages, v_pages=v_pages, k_scale=ks_pool,
        v_scale=vs_pool, lengths=cache.lengths + 1)


def paged_decode_step(q: jnp.ndarray, cache: PagedKVCache,
                      scale: Optional[float] = None,
                      window: int = 0,
                      windows: Optional[jnp.ndarray] = None):
    """Attend one query token per sequence against the paged cache,
    forwarding the full paged_decode_attention surface (sliding windows,
    per-seq dynamic windows)."""
    return paged_decode_attention(
        q, cache.k_pages, cache.v_pages, cache.page_table, cache.lengths,
        k_scale=cache.k_scale, v_scale=cache.v_scale, scale=scale,
        window=window, windows=windows)


def paged_bulk_append(cache: PagedKVCache, k_new: jnp.ndarray,
                      v_new: jnp.ndarray) -> PagedKVCache:
    """Append T tokens per sequence (k/v [B, Hkv, T, d]) — the paged
    PREFILL write. Requires every sequence's current length to be
    page-aligned (chunked prefill naturally uses page-aligned chunks);
    the caller must have reserved ceil(T/page_size) pages per sequence.
    One batched scatter per touched page slot."""
    from cuda_flashattention_tpu.ops.quant import quantize_tensor
    b, _, t, _ = k_new.shape
    ps = cache.page_size
    if not isinstance(cache.lengths, jax.core.Tracer):
        # the page-aligned-start precondition is enforceable whenever the
        # lengths are host-visible (the serving-driver path): a
        # non-aligned start would write chunk data at offset 0 of the
        # base page, clobbering that page's earlier live tokens
        off = np.asarray(cache.lengths) % ps
        if off.any():
            raise ValueError(
                f"paged_bulk_append requires page-aligned lengths "
                f"(page_size={ps}); got offsets {off.tolist()} — prefill "
                f"in page-aligned chunks or use paged_append per token")
    k_pages, v_pages = cache.k_pages, cache.v_pages
    ks_pool, vs_pool = cache.k_scale, cache.v_scale
    base = cache.lengths // ps  # page-aligned start slot per sequence
    rows = jnp.arange(b)
    for p in range(-(-t // ps)):
        w = min(ps, t - p * ps)
        pids = cache.page_table[rows, base + p]
        kc = k_new[:, :, p * ps:p * ps + w]
        vc = v_new[:, :, p * ps:p * ps + w]
        if cache.quantized:
            kt = "int8" if k_pages.dtype == jnp.int8 else "fp8"
            vt = "int8" if v_pages.dtype == jnp.int8 else "fp8"
            kq, ks = quantize_tensor(kc, kt)
            vq, vs = quantize_tensor(vc, vt)
            k_pages = k_pages.at[pids, :, :w].set(
                kq.astype(k_pages.dtype))
            v_pages = v_pages.at[pids, :, :w].set(
                vq.astype(v_pages.dtype))
            ks_pool = ks_pool.at[pids, :, :w].set(ks)
            vs_pool = vs_pool.at[pids, :, :w].set(vs)
        else:
            k_pages = k_pages.at[pids, :, :w].set(
                kc.astype(k_pages.dtype))
            v_pages = v_pages.at[pids, :, :w].set(
                vc.astype(v_pages.dtype))
    return dataclasses.replace(
        cache, k_pages=k_pages, v_pages=v_pages, k_scale=ks_pool,
        v_scale=vs_pool, lengths=cache.lengths + t)


def paged_prefix_attention(q: jnp.ndarray, cache: PagedKVCache,
                           scale: Optional[float] = None):
    """Attend a CHUNK of queries (q [B, H, C, d]) against the whole live
    paged cache (every cached token precedes the chunk, so the prefix is
    fully visible — no mask beyond the live length). Returns
    (o [B,H,C,d], lse [B,H,C]) for log-space combination with the chunk's
    own causal self-attention (parallel.ring.combine_partials), i.e. the
    paged counterpart of models.transformer.prefill_chunk's prefix term.

    Implementation: chunk rows fold into the decode kernel's query-group
    rows — all rows share the same visible key set."""
    b, h, c, d = q.shape
    o, lse = paged_decode_attention(
        q.reshape(b, h * c, d), cache.k_pages, cache.v_pages,
        cache.page_table, cache.lengths,
        k_scale=cache.k_scale, v_scale=cache.v_scale, scale=scale)
    return o.reshape(b, h, c, d), lse.reshape(b, h, c)
