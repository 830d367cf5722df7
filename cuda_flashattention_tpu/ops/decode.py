"""Single-token decode attention over a (possibly quantized) KV cache.

No reference analog (the CUDA ladder is prefill-only). Decode attention
is bound by memory bandwidth: every step reads the whole live cache once,
so int8/fp8 KV halves the bytes, and only pays when the dequant happens
on the way from memory to the tensor cores.

Design (split-K, as in JAX's own Pallas GPU decode kernel):
  * q for one step is [B, H, d]; GQA regroups it to [B, Hkv, G, d], so
    the G query heads sharing a KV head read that head's cache once as
    one (G, d)·(d, block_k) product. G is padded to Triton's dot minimum.
  * The grid is (n_splits, B, Hkv): each program takes a contiguous
    split of the cache, reads its sequence's live length and window start
    itself, loops over the cache tiles of its split that hold visible
    tokens, and writes a partial (o, lse). XLA merges the partials in log
    space (ops/common.merge_partials). The split count targets two waves
    of programs on the card's streaming multiprocessors, so short
    batches still fill the card and keep enough loads in flight.
  * K and V are loaded in their storage dtype and cast in-kernel, each
    by its own dtype (a mixed int8-K / fp8-V cache needs no special
    path); per-token scales multiply S's and P's columns.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl

from cuda_flashattention_tpu.ops.common import (
    LN2,
    LOG2E,
    NEG_INF,
    cdiv,
    check_triton_shape,
    dot_precision,
    merge_partials,
    next_pow2,
    pad_head_dim,
    pad_to_block,
    resolve_scale,
    triton_call_kwargs,
)

# Programs to aim for: four waves on the H100's 132 streaming
# multiprocessors. With 64-token tiles and 4 pipeline stages this
# measured fastest at 131k context (PERF.md, "Kernel decisions": int8
# 0.565 → 0.408 ms against two waves of 128-token tiles, 2 stages).
TARGET_PROGRAMS = 528
NUM_STAGES = 4


def decode_block_k(max_n: int, block_k: Optional[int] = None) -> int:
    """The cache tile: `block_k` (default 64) rounded to a power of two,
    shrunk until it divides the cache length when a power of two ≥ 16
    does, so the cache needs no padding copy per step."""
    bk = next_pow2(block_k or 64)
    bk = max(16, min(bk, next_pow2(max_n)))
    while bk > 16 and max_n % bk:
        bk //= 2
    return bk


def decode_splits(max_n: int, block_k: int,
                  programs: int) -> Tuple[int, int]:
    """(n_splits, tiles per split) for a cache of `max_n` tokens, where
    `programs` = B·Hkv programs exist per split."""
    n_tiles = cdiv(max_n, block_k)
    n_splits = max(1, min(cdiv(TARGET_PROGRAMS, programs), n_tiles))
    per_split = cdiv(n_tiles, n_splits)
    return cdiv(n_tiles, per_split), per_split


def _decode_kernel(*refs, scale2: float, block_k: int, tiles_per_split: int,
                   quantized: bool):
    q_ref, k_ref, v_ref, len_ref, start_ref, *rest = refs
    ks_ref = vs_ref = None
    if quantized:
        ks_ref, vs_ref, *rest = rest
    o_ref, lse_ref = rest

    split = pl.program_id(0)
    q = q_ref[...]                       # (G_pad, d)
    cd = q.dtype
    prec = dot_precision(cd)
    length = len_ref[...]
    start = start_ref[...]
    split_len = tiles_per_split * block_k
    lo_tok = jnp.maximum(start, split * split_len)
    hi_tok = jnp.minimum(length, (split + 1) * split_len)
    bk = jnp.int32(block_k)
    lo = lax.div(lo_tok, bk)
    hi = jnp.where(hi_tok > lo_tok, lax.div(hi_tok + (block_k - 1), bk), lo)

    def body(j, carry):
        acc, m, l = carry
        first = pl.multiple_of(j * block_k, block_k)
        kv_slice = pl.ds(first, block_k)
        k = k_ref[kv_slice, :].astype(cd)
        s = pl.dot(q, k, trans_b=True, precision=prec)     # (G_pad, bk)
        if quantized:
            s = s * (ks_ref[kv_slice] * scale2)[None, :]
        else:
            s = s * scale2
        cols = first + jnp.arange(block_k, dtype=jnp.int32)
        ok = ((cols >= start) & (cols < length))[None, :]
        s = jnp.where(ok, s, NEG_INF)
        m_new = jnp.maximum(m, jnp.max(s, axis=1))
        p = jnp.where(ok, jnp.exp2(s - m_new[:, None]), 0.0)
        alpha = jnp.exp2(m - m_new)
        l = l * alpha + jnp.sum(p, axis=1)
        if quantized:
            p = p * vs_ref[kv_slice][None, :]
        v = v_ref[kv_slice, :].astype(cd)
        acc = acc * alpha[:, None] + pl.dot(p.astype(cd), v, precision=prec)
        return acc, m_new, l

    g = q.shape[0]
    acc, m, l = lax.fori_loop(
        lo, hi, body,
        (jnp.zeros(q.shape, jnp.float32), jnp.full((g,), NEG_INF, jnp.float32),
         jnp.zeros((g,), jnp.float32)))
    empty = l == 0.0
    l_safe = jnp.where(empty, 1.0, l)
    o_ref[...] = acc / l_safe[:, None]
    lse_ref[...] = jnp.where(empty, NEG_INF, (m + jnp.log2(l_safe)) * LN2)


@functools.partial(jax.jit, static_argnames=("scale", "block_k", "window"))
def decode_attention(
    q: jnp.ndarray,
    k: jnp.ndarray,
    v: jnp.ndarray,
    lengths: jnp.ndarray,
    k_scale: Optional[jnp.ndarray] = None,
    v_scale: Optional[jnp.ndarray] = None,
    scale: Optional[float] = None,
    block_k: Optional[int] = None,
    window: int = 0,
    windows: Optional[jnp.ndarray] = None,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """One decode step: q [B,H,d] attends to cache k/v [B,Hkv,max_N,d].

    `lengths` [B] int32 gives each sequence's live context; cache rows at
    or beyond a sequence's length are never read nor attended. Quantized
    caches (int8 / fp8 per array) pass per-token scales [B,Hkv,max_N].

    `window` > 0 restricts attention to the last `window` live tokens
    (sliding-window serving); tiles before the window are not read.
    `windows` [B] int32 optionally gives PER-SEQUENCE windows (ring
    decode derives per-shard values from the shard offset —
    parallel/ring.py); with both set each effective window is
    min(windows[i], window). A window ≥ the length means no cut, one ≤ 0
    means nothing is visible.

    `block_k` overrides the cache tile (see decode_block_k); the split
    count follows from it and the number of programs (decode_splits).

    Returns (o [B,H,d], lse [B,H]) — LSE enables cross-shard combination
    for ring decode (parallel/ring.py).
    """
    b, h, d = q.shape
    _, h_kv, max_n, _ = k.shape
    if h % h_kv != 0:
        raise ValueError(f"q heads {h} not a multiple of kv heads {h_kv}")
    group = h // h_kv
    scale = resolve_scale(scale, d)
    quantized = k_scale is not None
    if quantized and v_scale is None:
        raise ValueError("k_scale given without v_scale")

    bk = decode_block_k(max_n, block_k)
    splits, per_split = decode_splits(max_n, bk, b * h_kv)
    # The cache is padded only when no legal tile divides it; every
    # split's loop stops at its sequence's length, so no tile past the
    # cache is ever read.
    k_p = pad_to_block(pad_head_dim(k), 2, bk)
    v_p = pad_to_block(pad_head_dim(v), 2, bk)
    max_np, dp = k_p.shape[2], k_p.shape[3]
    g_pad = max(16, next_pow2(group))
    check_triton_shape((g_pad, dp), (bk, dp))
    q_g = pad_head_dim(q).reshape(b, h_kv, group, dp)
    q_g = jnp.pad(q_g, ((0, 0), (0, 0), (0, g_pad - group), (0, 0)))

    lengths = jnp.broadcast_to(jnp.asarray(lengths, jnp.int32), (b,))
    window = int(window or 0)
    if windows is not None:
        win = jnp.broadcast_to(jnp.asarray(windows, jnp.int32), (b,))
        if window:
            win = jnp.minimum(win, window)
    elif window:
        win = jnp.full((b,), window, jnp.int32)
    else:
        win = None
    starts = (jnp.zeros((b,), jnp.int32) if win is None
              else jnp.clip(lengths - win, 0, lengths))

    def head(s, bb, hh):
        return (bb, hh, 0, 0)

    def seq(s, bb, hh):
        return (bb,)

    in_specs = [
        pl.BlockSpec((None, None, g_pad, dp), head),
        pl.BlockSpec((None, None, max_np, dp), head),
        pl.BlockSpec((None, None, max_np, dp), head),
        pl.BlockSpec((None,), seq),
        pl.BlockSpec((None,), seq),
    ]
    inputs = [q_g, k_p, v_p, lengths, starts]
    if quantized:
        for sc in (k_scale, v_scale):
            if sc.shape != (b, h_kv, max_n):
                raise ValueError(
                    f"scale shape {sc.shape} != {(b, h_kv, max_n)}")
            inputs.append(pad_to_block(sc.astype(jnp.float32), 2, bk))
            in_specs.append(pl.BlockSpec((None, None, max_np),
                                         lambda s, bb, hh: (bb, hh, 0)))

    o, lse = pl.pallas_call(
        functools.partial(_decode_kernel, scale2=scale * LOG2E,
                          block_k=bk, tiles_per_split=per_split,
                          quantized=quantized),
        grid=(splits, b, h_kv),
        in_specs=in_specs,
        out_specs=[
            pl.BlockSpec((None, None, None, g_pad, dp),
                         lambda s, bb, hh: (s, bb, hh, 0, 0)),
            pl.BlockSpec((None, None, None, g_pad),
                         lambda s, bb, hh: (s, bb, hh, 0)),
        ],
        out_shape=[
            jax.ShapeDtypeStruct((splits, b, h_kv, g_pad, dp), jnp.float32),
            jax.ShapeDtypeStruct((splits, b, h_kv, g_pad), jnp.float32),
        ],
        **triton_call_kwargs("decode_attention", num_warps=4,
                             num_stages=NUM_STAGES),
    )(*inputs)
    o, lse = merge_partials(o, lse, axis=0)
    o = o[:, :, :group, :d].reshape(b, h, d).astype(q.dtype)
    return o, lse[:, :, :group].reshape(b, h)
