"""FlashAttention-2 forward as a Pallas kernel on the Triton route.

Counterpart of the reference's FA2 forward CUDA kernel
(ref: src/02_flash_attention_v2_forward/flash_attention_kernel.cu:37-343
and the ring-ready variant src/03_flash_attention_v2_ring/common/
flash_attention_kernel.cu:13-172), in the same shape: one program per
(query tile, batch·head) keeps its Q tile and the fp32 (m, l, acc) state
in registers and loops over the KV tiles it can see, with an online
softmax; the epilogue writes O and the log-sum-exp the backward needs.

  CUDA reference                        → this kernel
  -------------------------------------   --------------------------------
  warp-partitioned Q rows, Q in regs     → (block_q, d) Q tile per program
  K/V tiles staged in shared memory      → K/V tiles loaded per loop step;
    (kernel.cu:52-54)                      Triton pipelines the loads
                                           (num_stages)
  m/l in registers per row               → (m, l, acc) fori_loop carry
  epilogue O←O_acc/l, L←m+log l          → the same, after the loop
  <Br,Bc,d,warps> template params        → BlockSizes + num_warps

Extensions over the reference: batch/head dims, bf16 inputs with fp32
accumulation, causal masking with a global `kv_offset`, a causal sliding
`window`, padding for non-divisible shapes, GQA (the KV head is found by
index, never repeated), packed segments, and int8/fp8 K/V with per-token
scales: K/V are loaded in their storage dtype, cast in-kernel, and the
scales multiply S's columns and P's columns.

The loop visits only the KV tiles the tile's rows can see, and splits
them into an unmasked middle and masked edges (ops/common.kv_tile_range):
interior tiles of a causal or windowed band pay no mask.
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
    BlockSizes,
    attention_mask,
    cdiv,
    check_triton_shape,
    dot_precision,
    kv_tile_range,
    num_warps_for,
    pad_head_dim,
    pad_to_block,
    resolve_scale,
    triton_call_kwargs,
)


def _fwd_kernel(*refs, scale2: float, causal: bool, window: int,
                kv_offset: int, nk_valid: int, block_q: int, block_k: int,
                n_q_tiles: int, n_kv_tiles: int, quantized: bool,
                segmented: bool):
    q_ref, k_ref, v_ref, *rest = refs
    ks_ref = vs_ref = qseg_ref = kseg_ref = None
    if quantized:
        ks_ref, vs_ref, *rest = rest
    if segmented:
        qseg_ref, kseg_ref, *rest = rest
    o_ref, lse_ref = rest

    # heavy (late, causal) query tiles launch first
    iq = n_q_tiles - 1 - pl.program_id(0)
    q = q_ref[...]
    cd = q.dtype
    prec = dot_precision(cd)
    q_first = iq * block_q + kv_offset
    rows = q_first + jnp.arange(block_q, dtype=jnp.int32)
    qseg = qseg_ref[...] if segmented else None

    def body(j, carry, masked: bool):
        acc, m, l = carry
        start = pl.multiple_of(j * block_k, block_k)
        kv_slice = pl.ds(start, block_k)
        k = k_ref[kv_slice, :].astype(cd)
        s = pl.dot(q, k, trans_b=True, precision=prec)  # (bq, bk) fp32
        if quantized:
            s = s * (ks_ref[kv_slice] * scale2)[None, :]
        else:
            s = s * scale2
        if masked:
            cols = start + jnp.arange(block_k, dtype=jnp.int32)
            ok = attention_mask(
                rows, cols, causal=causal, window=window,
                nk_valid=nk_valid if nk_valid % block_k else None,
                qseg=qseg, kseg=kseg_ref[kv_slice] if segmented else None)
            s = jnp.where(ok, s, NEG_INF)
        m_new = jnp.maximum(m, jnp.max(s, axis=1))
        p = jnp.exp2(s - m_new[:, None])
        if masked:
            # a row with nothing visible yet has m_new == NEG_INF and would
            # otherwise weigh its masked entries exp2(0) = 1
            p = jnp.where(ok, p, 0.0)
        alpha = jnp.exp2(m - m_new)
        l = l * alpha + jnp.sum(p, axis=1)
        if quantized:
            p = p * vs_ref[kv_slice][None, :]
        v = v_ref[kv_slice, :].astype(cd)
        acc = acc * alpha[:, None] + pl.dot(p.astype(cd), v, precision=prec)
        return acc, m_new, l

    lo, full_lo, full_hi, hi = kv_tile_range(
        q_first, block_q=block_q, block_k=block_k, n_kv_tiles=n_kv_tiles,
        causal=causal, window=window, nk_valid=nk_valid,
        segmented=segmented)
    carry = (jnp.zeros(q.shape, jnp.float32),
             jnp.full((block_q,), NEG_INF, jnp.float32),
             jnp.zeros((block_q,), jnp.float32))
    masked_body = functools.partial(body, masked=True)
    carry = lax.fori_loop(lo, full_lo, masked_body, carry)
    carry = lax.fori_loop(full_lo, full_hi,
                          functools.partial(body, masked=False), carry)
    acc, m, l = lax.fori_loop(full_hi, hi, masked_body, carry)

    # O ← O_acc / l and L ← m + log l (ref: kernel.cu:280-296); m is in
    # log2 units, LSE leaves in natural-log units. Rows that saw nothing
    # emit O = 0, LSE = NEG_INF.
    empty = l == 0.0
    l_safe = jnp.where(empty, 1.0, l)
    o_ref[...] = (acc / l_safe[:, None]).astype(o_ref.dtype)
    lse_ref[...] = jnp.where(empty, NEG_INF, (m + jnp.log2(l_safe)) * LN2)


@functools.partial(
    jax.jit,
    static_argnames=("scale", "causal", "window", "kv_offset",
                     "block_sizes", "out_dtype"),
)
def flash_attention_forward(
    q: jnp.ndarray,
    k: jnp.ndarray,
    v: jnp.ndarray,
    scale: Optional[float] = None,
    causal: bool = False,
    window: int = 0,
    kv_offset: int = 0,
    block_sizes: Optional[BlockSizes] = None,
    out_dtype=None,
    k_scale: Optional[jnp.ndarray] = None,
    v_scale: Optional[jnp.ndarray] = None,
    q_segment_ids: Optional[jnp.ndarray] = None,
    kv_segment_ids: Optional[jnp.ndarray] = None,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """FA2 forward. q [B,H,Nq,d], k/v [B,Hkv,Nk,d] → (O [B,H,Nq,d], LSE [B,H,Nq]).

    Host-side counterpart of `flash_attention_2_forward`
    (ref: 02_fwd/flash_attention_kernel.cu:300-343): resolves tiles, pads
    non-divisible shapes, builds the grid, and launches the kernel. H
    must be a multiple of Hkv (GQA).

    Quantized KV: pass k/v as int8 or float8_e4m3fn plus per-token fp32
    scales k_scale/v_scale [B,Hkv,Nk]; dequant folds into S's and P's
    columns in-kernel (see ops.quant for the quantiser).

    Rows with no visible key (causal rows before `kv_offset`'s shard, a
    window wholly outside the keys, or an empty segment) return O = 0 and
    LSE = NEG_INF, so a log-space merge drops them.
    """
    if q.ndim != 4:
        raise ValueError(f"expected q [B,H,N,d], got {q.shape}")
    b, h, nq, d = q.shape
    _, h_kv, nk, _ = k.shape
    if h % h_kv != 0:
        raise ValueError(f"q heads {h} not a multiple of kv heads {h_kv}")
    group = h // h_kv
    scale = resolve_scale(scale, d)
    out_dtype = q.dtype if out_dtype is None else out_dtype
    quantized = k_scale is not None
    if quantized and v_scale is None:
        raise ValueError("k_scale given without v_scale")
    segmented = q_segment_ids is not None
    if segmented and kv_segment_ids is None:
        raise ValueError("q_segment_ids given without kv_segment_ids")
    window = int(window or 0)
    if window and not causal:
        raise ValueError("window requires causal=True (causal sliding "
                         "window attention)")

    bs = (block_sizes or BlockSizes()).clamp(nq, nk)
    block_q, block_k = bs.block_q, bs.block_k
    q_p = pad_to_block(pad_head_dim(q), 2, block_q)
    k_p = pad_to_block(pad_head_dim(k), 2, block_k)
    v_p = pad_to_block(pad_head_dim(v), 2, block_k)
    dp = q_p.shape[-1]
    check_triton_shape((block_q, dp), (block_k, dp))
    nq_p, nk_p = q_p.shape[2], k_p.shape[2]
    nqb, nkb = nq_p // block_q, nk_p // block_k

    def q_map(i, bh):
        return (bh // h, bh % h, nqb - 1 - i, 0)

    def kv_map(i, bh):
        return (bh // h, (bh % h) // group, 0, 0)

    def row_map(i, bh):
        return (bh // h, bh % h, nqb - 1 - i)

    in_specs = [
        pl.BlockSpec((None, None, block_q, dp), q_map),
        pl.BlockSpec((None, None, nk_p, dp), kv_map),
        pl.BlockSpec((None, None, nk_p, dp), kv_map),
    ]
    inputs = [q_p, k_p, v_p]
    if quantized:
        for sc in (k_scale, v_scale):
            if sc.shape != (b, h_kv, nk):
                raise ValueError(
                    f"scale shape {sc.shape} != {(b, h_kv, nk)}")
            inputs.append(pad_to_block(sc.astype(jnp.float32), 2, block_k))
            in_specs.append(pl.BlockSpec(
                (None, None, nk_p), lambda i, bh: (bh // h, (bh % h) // group,
                                                   0)))
    if segmented:
        # distinct pad ids (-1 rows, -2 columns) so padding matches nothing
        inputs.append(pad_to_block(
            jnp.asarray(q_segment_ids, jnp.int32), 1, block_q, value=-1))
        in_specs.append(pl.BlockSpec(
            (None, block_q), lambda i, bh: (bh // h, nqb - 1 - i)))
        inputs.append(pad_to_block(
            jnp.asarray(kv_segment_ids, jnp.int32), 1, block_k, value=-2))
        in_specs.append(pl.BlockSpec(
            (None, nk_p), lambda i, bh: (bh // h, 0)))

    kernel = functools.partial(
        _fwd_kernel, scale2=scale * LOG2E, causal=bool(causal),
        window=window, kv_offset=kv_offset, nk_valid=nk, block_q=block_q,
        block_k=block_k, n_q_tiles=nqb, n_kv_tiles=nkb,
        quantized=quantized, segmented=segmented)
    o, lse = pl.pallas_call(
        kernel,
        grid=(nqb, b * h),
        in_specs=in_specs,
        out_specs=[
            pl.BlockSpec((None, None, block_q, dp), q_map),
            pl.BlockSpec((None, None, block_q), row_map),
        ],
        out_shape=[
            jax.ShapeDtypeStruct((b, h, nq_p, dp), out_dtype),
            jax.ShapeDtypeStruct((b, h, nq_p), jnp.float32),
        ],
        **triton_call_kwargs("flash_fwd", num_warps_for(block_q, dp),
                             num_stages=3 if cdiv(nk, block_k) > 2 else 2),
    )(*inputs)
    return o[:, :, :nq, :d], lse[:, :, :nq]
