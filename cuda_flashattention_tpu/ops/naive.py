"""Golden oracle: exact softmax attention, forward and backward.

Counterpart of the reference's CPU oracle
(ref: src/util/naive_attention.h:7-161, src/00_naive_attention/main.cpp:8-38).
Like the reference, the forward emits the log-sum-exp `L[i] = m_i + log(l_i)`
per query row (ref: naive_attention.h:41-42) so the FlashAttention backward
can be validated against recomputed probabilities, and the backward
materialises the full softmax Jacobian (ref: naive_attention.h:130-140).

Written in plain jax.numpy with fp32 (optionally fp64) accumulation — this
runs on CPU or GPU, is O(N^2) in memory, and is the correctness bar every
Pallas kernel in ops/ is compared against (tests mirror the reference's
oracle-compare discipline, SURVEY.md §4).

Every einsum is pinned to Precision.HIGHEST: on the GPU the default fp32
matmul precision may be TF32, which keeps about three decimal digits —
an oracle that drifts with the backend is no oracle.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np


def _as_f32(x) -> jnp.ndarray:
    return jnp.asarray(x, dtype=jnp.float32)


def naive_attention(
    q,
    k,
    v,
    scale: Optional[float] = None,
    causal: bool = False,
    window: int = 0,
    kv_offset: int = 0,
    q_segment_ids=None,
    kv_segment_ids=None,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Exact attention forward; returns (O, LSE).

    Shapes: q [..., Nq, d], k/v [..., Nk, d] — any leading batch/head dims
    (the reference is single-head [N, d]; ref: naive_attention.h:7-61).

    ``causal`` masks position pairs where global_k > global_q with
    global_q = i + kv_offset (the reference has no masking — SURVEY.md §2.3
    "no causal masking anywhere"; we support it because ring attention and
    real models need it).

    Returns O in fp32 and LSE = m + log(sum exp(s - m)) per row
    (ref: naive_attention.h:41-42).
    """
    q, k, v = _as_f32(q), _as_f32(k), _as_f32(v)
    d = q.shape[-1]
    if scale is None:
        scale = 1.0 / float(np.sqrt(d))
    s = jnp.einsum("...qd,...kd->...qk", q, k,
                   precision=jax.lax.Precision.HIGHEST) * scale
    if causal:
        nq, nk = q.shape[-2], k.shape[-2]
        qi = jnp.arange(nq)[:, None] + kv_offset
        kj = jnp.arange(nk)[None, :]
        s = jnp.where(kj <= qi, s, -jnp.inf)
        if window:
            s = jnp.where(kj > qi - window, s, -jnp.inf)
    if q_segment_ids is not None:
        # packed sequences: [B, Nq]/[B, Nk] ids; cross-segment pairs masked
        qs = jnp.asarray(q_segment_ids)[:, None, :, None]  # [B,1,Nq,1]
        ks = jnp.asarray(kv_segment_ids)[:, None, None, :]
        s = jnp.where(qs == ks, s, -jnp.inf)
    m = jnp.max(s, axis=-1, keepdims=True)
    # Fully-masked rows: keep exp() finite; their output is defined as 0.
    m_safe = jnp.where(jnp.isfinite(m), m, 0.0)
    p = jnp.exp(s - m_safe)
    p = jnp.where(jnp.isfinite(s), p, 0.0)
    l = jnp.sum(p, axis=-1, keepdims=True)
    o = jnp.einsum("...qk,...kd->...qd", p, v,
                   precision=jax.lax.Precision.HIGHEST) / jnp.maximum(l, 1e-30)
    lse = (m_safe + jnp.log(jnp.maximum(l, 1e-30)))[..., 0]
    return o, lse


def naive_attention_backward(
    q,
    k,
    v,
    do,
    scale: Optional[float] = None,
    causal: bool = False,
    window: int = 0,
    kv_offset: int = 0,
    q_segment_ids=None,
    kv_segment_ids=None,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Exact attention backward via the explicit softmax Jacobian.

    Mirrors the reference's full-materialisation gradient math
    (ref: naive_attention.h:84-161): dV = Pᵀ·dO (:113-119), dP = dO·Vᵀ
    (:121-127), dS = P ⊙ (dP − rowsum(P ⊙ dP)) (:130-140, the softmax
    Jacobian reduces to this), dQ = dS·K·scale (:142-147),
    dK = dSᵀ·Q·scale (:149-155).

    Returns (dQ, dK, dV) in fp32.
    """
    q, k, v, do = _as_f32(q), _as_f32(k), _as_f32(v), _as_f32(do)
    d = q.shape[-1]
    if scale is None:
        scale = 1.0 / float(np.sqrt(d))
    s = jnp.einsum("...qd,...kd->...qk", q, k,
                   precision=jax.lax.Precision.HIGHEST) * scale
    if causal:
        nq, nk = q.shape[-2], k.shape[-2]
        qi = jnp.arange(nq)[:, None] + kv_offset
        kj = jnp.arange(nk)[None, :]
        s = jnp.where(kj <= qi, s, -jnp.inf)
        if window:
            s = jnp.where(kj > qi - window, s, -jnp.inf)
    if q_segment_ids is not None:
        qs = jnp.asarray(q_segment_ids)[:, None, :, None]
        ks = jnp.asarray(kv_segment_ids)[:, None, None, :]
        s = jnp.where(qs == ks, s, -jnp.inf)
    p = jax.nn.softmax(s, axis=-1)
    p = jnp.where(jnp.isfinite(s), p, 0.0)
    dv = jnp.einsum("...qk,...qd->...kd", p, do,
                    precision=jax.lax.Precision.HIGHEST)
    dp = jnp.einsum("...qd,...kd->...qk", do, v,
                    precision=jax.lax.Precision.HIGHEST)
    # rowsum(P ⊙ dP) == rowsum(dO ⊙ O) == the backward's "D" vector
    # (ref: flash_attention_backward_kernel.cu:94-120 computes it as the
    # latter; the two are equal by O = P·V).
    delta = jnp.sum(p * dp, axis=-1, keepdims=True)
    ds = p * (dp - delta) * scale
    dq = jnp.einsum("...qk,...kd->...qd", ds, k,
                    precision=jax.lax.Precision.HIGHEST)
    dk = jnp.einsum("...qk,...qd->...kd", ds, q,
                    precision=jax.lax.Precision.HIGHEST)
    return dq, dk, dv


def naive_decode(q, k, v, scale: Optional[float] = None) -> jnp.ndarray:
    """Single-query exact attention (decode step oracle): q [..., d]."""
    o, _ = naive_attention(q[..., None, :], k, v, scale=scale)
    return o[..., 0, :]
