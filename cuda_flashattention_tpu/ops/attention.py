"""Public attention API: differentiable FlashAttention-2.

Host orchestration layer (L3) of the framework — the counterpart of the
reference's host wrapper functions (`flash_attention_2_forward`,
ref: 02_fwd/flash_attention_kernel.cu:300-343; `flash_attention_2_backward`,
ref: 02_bwd/flash_attention_backward_kernel.cu:249-299), except that here
forward and backward are fused into one differentiable op via
`jax.custom_vjp` so `jax.grad` works end-to-end (the reference has no
autodiff; its tests call fwd and bwd separately).
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp

from cuda_flashattention_tpu.ops.common import BlockSizes
from cuda_flashattention_tpu.ops.flash_bwd import flash_attention_backward
from cuda_flashattention_tpu.ops.flash_fwd import flash_attention_forward


@functools.partial(
    jax.custom_vjp, nondiff_argnums=(5, 6, 7, 8, 9))
def _flash_attention(q, k, v, q_seg, kv_seg, scale, causal, window,
                     kv_offset, block_sizes):
    o, _ = flash_attention_forward(
        q, k, v, scale=scale, causal=causal, window=window,
        kv_offset=kv_offset, block_sizes=block_sizes,
        q_segment_ids=q_seg, kv_segment_ids=kv_seg)
    return o


def _fwd(q, k, v, q_seg, kv_seg, scale, causal, window, kv_offset,
         block_sizes):
    o, lse = flash_attention_forward(
        q, k, v, scale=scale, causal=causal, window=window,
        kv_offset=kv_offset, block_sizes=block_sizes,
        q_segment_ids=q_seg, kv_segment_ids=kv_seg)
    return o, (q, k, v, q_seg, kv_seg, o, lse)


def _bwd(scale, causal, window, kv_offset, block_sizes, res, do):
    q, k, v, q_seg, kv_seg, o, lse = res
    # GQA runs natively in the backward kernels: each dK/dV program loops
    # over all query heads that share its KV head.
    dq, dk, dv = flash_attention_backward(
        q, k, v, o, lse, do, scale=scale, causal=causal, window=window,
        kv_offset=kv_offset, block_sizes=block_sizes,
        q_segment_ids=q_seg, kv_segment_ids=kv_seg)
    # segment ids are integer inputs: no cotangent (None = symbolic zero)
    return dq, dk, dv, None, None


_flash_attention.defvjp(_fwd, _bwd)


def flash_attention(
    q: jnp.ndarray,
    k: jnp.ndarray,
    v: jnp.ndarray,
    scale: Optional[float] = None,
    causal: bool = False,
    window: int = 0,
    kv_offset: int = 0,
    block_sizes: Optional[BlockSizes] = None,
    q_segment_ids: Optional[jnp.ndarray] = None,
    kv_segment_ids: Optional[jnp.ndarray] = None,
) -> jnp.ndarray:
    """Differentiable FlashAttention-2: q [B,H,Nq,d], k/v [B,Hkv,Nk,d] → O.

    Supports GQA/MQA (Hkv dividing H), causal masking with a global
    `kv_offset` (for sequence-sharded callers), sliding-window (local)
    attention via `window` (each query sees the last `window` keys;
    off-window KV blocks are skipped, compute AND fetch), packed
    sequences via
    `q_segment_ids`/`kv_segment_ids` [B, N] (cross-segment attention
    masked, fwd and bwd), bf16/fp32 inputs with fp32 accumulation, and
    arbitrary (non-tile-divisible) sequence lengths and head dims.
    """
    return _flash_attention(q, k, v, q_segment_ids, kv_segment_ids, scale,
                            causal, window, kv_offset, block_sizes)


def mha(
    q: jnp.ndarray,
    k: jnp.ndarray,
    v: jnp.ndarray,
    scale: Optional[float] = None,
    causal: bool = False,
) -> jnp.ndarray:
    """Convenience wrapper in [B, N, H, d] (sequence-major) layout —
    the layout models typically carry activations in."""
    o = flash_attention(
        q.transpose(0, 2, 1, 3), k.transpose(0, 2, 1, 3),
        v.transpose(0, 2, 1, 3), scale=scale, causal=causal)
    return o.transpose(0, 2, 1, 3)
