"""FlashAttention-2 backward as two Pallas kernels on the Triton route.

Counterpart of the reference's FA2 backward CUDA kernel
(ref: src/02_flash_attention_v2_backward/flash_attention_backward_kernel.cu
:47-299). Same math — recompute S from Q/K, P = exp(S − LSE) from the saved
log-sum-exp (no max pass, ref: :169-174), D = rowsum(dO ⊙ O)
(ref: :94-120), dS = P ⊙ (dP − D) (ref: :189-193) — but with the two
race-free kernels of the split FA2 backward instead of the reference's
atomicAdd into dK/dV (ref: :207-231):

  * dK/dV kernel: one program per (KV tile, batch·KV head). It loops over
    the query tiles that see its keys, and over the query heads of its
    GQA group, accumulating dK/dV in registers: no atomics, no repeat.
  * dQ kernel: one program per (query tile, batch·head), looping over the
    KV tiles its rows see (ref: :195-205, 234-245).

S and dP are recomputed in each (the usual trade of FLOPs for bandwidth),
and D is one fused XLA reduction outside the kernels.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl

from cuda_flashattention_tpu.ops.common import (
    LOG2E,
    NEG_INF,
    BlockSizes,
    attention_mask,
    check_triton_shape,
    dot_precision,
    kv_tile_range,
    num_warps_for,
    pad_head_dim,
    pad_to_block,
    q_tile_range,
    resolve_scale,
    triton_call_kwargs,
)


def _p_ds(q, k, v, do, lse2, delta, scale2, prec, ok):
    """S → P = exp2(S − LSE) → dP = dO·Vᵀ → dS = P ⊙ (dP − D), all fp32
    (the caller applies the softmax scale to the gradient it owns).
    `ok` is the visibility mask, or None for a fully visible tile."""
    s = pl.dot(q, k, trans_b=True, precision=prec) * scale2
    p = jnp.exp2(s - lse2[:, None])
    if ok is not None:
        p = jnp.where(ok, p, 0.0)
    dp = pl.dot(do, v, trans_b=True, precision=prec)
    return p, p * (dp - delta[:, None])


def _dkdv_kernel(*refs, scale: float, causal: bool, window: int,
                 kv_offset: int, block_q: int, block_k: int,
                 n_q_tiles: int, group: int, segmented: bool):
    q_ref, k_ref, v_ref, do_ref, lse_ref, delta_ref, *rest = refs
    qseg_ref = kseg_ref = None
    if segmented:
        qseg_ref, kseg_ref, *rest = rest
    dk_ref, dv_ref = rest

    j = pl.program_id(0)
    k = k_ref[...]
    v = v_ref[...]
    cd = k.dtype
    prec = dot_precision(cd)
    k_first = j * block_k
    cols = k_first + jnp.arange(block_k, dtype=jnp.int32)
    kseg = kseg_ref[...] if segmented else None
    lo, full_lo, full_hi, hi = q_tile_range(
        k_first, block_q=block_q, block_k=block_k, n_q_tiles=n_q_tiles,
        causal=causal, window=window, kv_offset=kv_offset,
        segmented=segmented)

    def body(i, carry, g, masked: bool):
        dk, dv = carry
        start = pl.multiple_of(i * block_q, block_q)
        q_slice = pl.ds(start, block_q)
        q = q_ref[g, q_slice, :]
        do = do_ref[g, q_slice, :]
        ok = None
        if masked:
            rows = start + kv_offset + jnp.arange(block_q, dtype=jnp.int32)
            ok = attention_mask(
                rows, cols, causal=causal, window=window,
                qseg=qseg_ref[q_slice] if segmented else None, kseg=kseg)
        p, ds = _p_ds(q, k, v, do, lse_ref[g, q_slice],
                      delta_ref[g, q_slice], scale * LOG2E, prec, ok)
        dv = dv + pl.dot(p.astype(cd), do, trans_a=True, precision=prec)
        dk = dk + pl.dot(ds.astype(cd), q, trans_a=True, precision=prec)
        return dk, dv

    def head(g, carry):
        masked = functools.partial(body, g=g, masked=True)
        carry = lax.fori_loop(lo, full_lo, masked, carry)
        carry = lax.fori_loop(full_lo, full_hi,
                              functools.partial(body, g=g, masked=False),
                              carry)
        return lax.fori_loop(full_hi, hi, masked, carry)

    zeros = jnp.zeros(k.shape, jnp.float32)
    dk, dv = lax.fori_loop(0, group, head, (zeros, zeros))
    dk_ref[...] = (dk * scale).astype(dk_ref.dtype)
    dv_ref[...] = dv.astype(dv_ref.dtype)


def _dq_kernel(*refs, scale: float, causal: bool, window: int,
               kv_offset: int, nk_valid: int, block_q: int, block_k: int,
               n_kv_tiles: int, segmented: bool):
    q_ref, k_ref, v_ref, do_ref, lse_ref, delta_ref, *rest = refs
    qseg_ref = kseg_ref = None
    if segmented:
        qseg_ref, kseg_ref, *rest = rest
    (dq_ref,) = rest

    i = pl.program_id(0)
    q = q_ref[...]
    do = do_ref[...]
    lse2 = lse_ref[...]
    delta = delta_ref[...]
    cd = q.dtype
    prec = dot_precision(cd)
    q_first = i * block_q + kv_offset
    rows = q_first + jnp.arange(block_q, dtype=jnp.int32)
    qseg = qseg_ref[...] if segmented else None

    def body(j, dq, masked: bool):
        start = pl.multiple_of(j * block_k, block_k)
        kv_slice = pl.ds(start, block_k)
        k = k_ref[kv_slice, :]
        ok = None
        if masked:
            cols = start + jnp.arange(block_k, dtype=jnp.int32)
            ok = attention_mask(
                rows, cols, causal=causal, window=window,
                nk_valid=nk_valid if nk_valid % block_k else None,
                qseg=qseg, kseg=kseg_ref[kv_slice] if segmented else None)
        _, ds = _p_ds(q, k, v_ref[kv_slice, :], do, lse2, delta,
                      scale * LOG2E, prec, ok)
        return dq + pl.dot(ds.astype(cd), k, precision=prec)

    lo, full_lo, full_hi, hi = kv_tile_range(
        q_first, block_q=block_q, block_k=block_k, n_kv_tiles=n_kv_tiles,
        causal=causal, window=window, nk_valid=nk_valid,
        segmented=segmented)
    masked = functools.partial(body, masked=True)
    dq = jnp.zeros(q.shape, jnp.float32)
    dq = lax.fori_loop(lo, full_lo, masked, dq)
    dq = lax.fori_loop(full_lo, full_hi,
                       functools.partial(body, masked=False), dq)
    dq = lax.fori_loop(full_hi, hi, masked, dq)
    dq_ref[...] = (dq * scale).astype(dq_ref.dtype)


@functools.partial(
    jax.jit,
    static_argnames=("scale", "causal", "window", "kv_offset",
                     "block_sizes"),
)
def flash_attention_backward(
    q: jnp.ndarray,
    k: jnp.ndarray,
    v: jnp.ndarray,
    o: jnp.ndarray,
    lse: jnp.ndarray,
    do: jnp.ndarray,
    scale: Optional[float] = None,
    causal: bool = False,
    window: int = 0,
    kv_offset: int = 0,
    block_sizes: Optional[BlockSizes] = None,
    q_segment_ids: Optional[jnp.ndarray] = None,
    kv_segment_ids: Optional[jnp.ndarray] = None,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """FA2 backward. q/o/do are [B,H,Nq,d], k/v are [B,Hkv,Nk,d] (GQA when
    Hkv < H); lse [B,H,Nq] from the forward (natural log, NEG_INF for rows
    that saw nothing).

    Host-side counterpart of `flash_attention_2_backward`
    (ref: backward_kernel.cu:249-299). Returns (dQ [B,H,Nq,d],
    dK/dV [B,Hkv,Nk,d]) in the input dtypes.
    """
    b, h, nq, d = q.shape
    h_kv, nk = k.shape[1], k.shape[2]
    if h % h_kv != 0:
        raise ValueError(f"q heads {h} not a multiple of kv heads {h_kv}")
    group = h // h_kv
    scale = resolve_scale(scale, d)
    window = int(window or 0)
    if window and not causal:
        raise ValueError("window requires causal=True")
    segmented = q_segment_ids is not None

    bs = (block_sizes or BlockSizes()).clamp(nq, nk)
    block_q, block_k = bs.block_q_bwd, bs.block_k_bwd

    # D = rowsum(dO ⊙ O) (ref kernel prologue :94-120), one fused XLA op;
    # LSE moves to log2 units, and a row that saw nothing gets +inf so
    # its P is exactly 0. Padded rows have dO = 0, hence zero gradients.
    delta = jnp.sum(do.astype(jnp.float32) * o.astype(jnp.float32), axis=-1)
    lse2 = jnp.where(lse <= NEG_INF * 0.5, jnp.inf, lse * LOG2E)
    q_p = pad_to_block(pad_head_dim(q), 2, block_q)
    do_p = pad_to_block(pad_head_dim(do), 2, block_q)
    lse_p = pad_to_block(lse2, 2, block_q, value=jnp.inf)
    delta_p = pad_to_block(delta, 2, block_q)
    k_p = pad_to_block(pad_head_dim(k), 2, block_k)
    v_p = pad_to_block(pad_head_dim(v), 2, block_k)
    dp = q_p.shape[-1]
    check_triton_shape((block_q, dp), (block_k, dp))
    nq_p, nk_p = q_p.shape[2], k_p.shape[2]
    nqb, nkb = nq_p // block_q, nk_p // block_k
    seg_inputs = []
    if segmented:
        seg_inputs = [
            pad_to_block(jnp.asarray(q_segment_ids, jnp.int32), 1, block_q,
                         value=-1),
            pad_to_block(jnp.asarray(kv_segment_ids, jnp.int32), 1,
                         block_k, value=-2),
        ]
    common = dict(scale=scale, causal=bool(causal), window=window,
                  kv_offset=kv_offset, block_q=block_q, block_k=block_k,
                  segmented=segmented)
    warps = num_warps_for(max(block_q, block_k), dp)

    # dK/dV: program (KV tile j, batch·KV head); the Q-side operands of
    # the whole GQA group come in as one [group, Nq] slab.
    def grp(j, bh):
        return (bh // h_kv, bh % h_kv, 0, 0)

    def grp_row(j, bh):
        return (bh // h_kv, bh % h_kv, 0)

    def kv_tile(j, bh):
        return (bh // h_kv, bh % h_kv, j, 0)

    seg_specs = [
        pl.BlockSpec((None, nq_p), lambda j, bh: (bh // h_kv, 0)),
        pl.BlockSpec((None, block_k), lambda j, bh: (bh // h_kv, j)),
    ] if segmented else []
    dk, dv = pl.pallas_call(
        functools.partial(_dkdv_kernel, n_q_tiles=nqb, group=group,
                          **common),
        grid=(nkb, b * h_kv),
        in_specs=[
            pl.BlockSpec((None, group, nq_p, dp), grp),
            pl.BlockSpec((None, None, block_k, dp), kv_tile),
            pl.BlockSpec((None, None, block_k, dp), kv_tile),
            pl.BlockSpec((None, group, nq_p, dp), grp),
            pl.BlockSpec((None, group, nq_p), grp_row),
            pl.BlockSpec((None, group, nq_p), grp_row),
            *seg_specs,
        ],
        out_specs=[
            pl.BlockSpec((None, None, block_k, dp), kv_tile),
            pl.BlockSpec((None, None, block_k, dp), kv_tile),
        ],
        out_shape=[
            jax.ShapeDtypeStruct(k_p.shape, k.dtype),
            jax.ShapeDtypeStruct(v_p.shape, v.dtype),
        ],
        **triton_call_kwargs("flash_bwd_dkdv", warps, num_stages=2),
    )(q_p, k_p, v_p, do_p, lse_p, delta_p, *seg_inputs)

    # dQ: program (query tile i, batch·head), KV of its group's head.
    def q_tile(i, bh):
        return (bh // h, bh % h, i, 0)

    def q_row(i, bh):
        return (bh // h, bh % h, i)

    def kv_all(i, bh):
        return (bh // h, (bh % h) // group, 0, 0)

    seg_specs = [
        pl.BlockSpec((None, block_q), lambda i, bh: (bh // h, i)),
        pl.BlockSpec((None, nk_p), lambda i, bh: (bh // h, 0)),
    ] if segmented else []
    dq = pl.pallas_call(
        functools.partial(_dq_kernel, nk_valid=nk, n_kv_tiles=nkb,
                          **common),
        grid=(nqb, b * h),
        in_specs=[
            pl.BlockSpec((None, None, block_q, dp), q_tile),
            pl.BlockSpec((None, None, nk_p, dp), kv_all),
            pl.BlockSpec((None, None, nk_p, dp), kv_all),
            pl.BlockSpec((None, None, block_q, dp), q_tile),
            pl.BlockSpec((None, None, block_q), q_row),
            pl.BlockSpec((None, None, block_q), q_row),
            *seg_specs,
        ],
        out_specs=pl.BlockSpec((None, None, block_q, dp), q_tile),
        out_shape=jax.ShapeDtypeStruct(q_p.shape, q.dtype),
        **triton_call_kwargs("flash_bwd_dq", warps, num_stages=2),
    )(q_p, k_p, v_p, do_p, lse_p, delta_p, *seg_inputs)

    return dq[:, :, :nq, :d], dk[:, :, :nk, :d], dv[:, :, :nk, :d]
