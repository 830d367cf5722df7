"""Autoregressive generation: prefill + scanned decode over the KV cache.

The serving loop that ties the framework together end-to-end: FA2 prefill
fills the (optionally FP8/INT8-quantized) caches, then a `lax.scan` of
single-token decode steps reads them through the fused-dequant decode
kernel. No reference analog (the CUDA ladder has no inference loop).

The cache is preallocated (static shapes), the scan is one compiled
program (no per-token dispatch from Python), and sampling is functional
(a threaded PRNG key).
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from cuda_flashattention_tpu.models.transformer import (
    TransformerConfig,
    decode_one,
    init_caches,
    prefill,
)


def _sample(logits: jnp.ndarray, key, temperature: float) -> jnp.ndarray:
    if temperature == 0.0:
        return jnp.argmax(logits, axis=-1).astype(jnp.int32)
    return jax.random.categorical(
        key, logits / temperature, axis=-1).astype(jnp.int32)


@functools.partial(
    jax.jit,
    static_argnames=("cfg", "max_new_tokens", "max_len", "qtype",
                     "temperature"),
)
def generate(
    params,
    prompt: jnp.ndarray,
    cfg: TransformerConfig,
    max_new_tokens: int,
    max_len: Optional[int] = None,
    qtype: Optional[str] = None,
    temperature: float = 0.0,
    key: Optional[jax.Array] = None,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Generate continuations. prompt [B, T] int32 → (tokens [B, T+N],
    logits_last [B, V]).

    qtype None/"int8"/"fp8"/"mixed" selects the cache storage; decode
    reads it through the fused-dequant kernel either way. temperature 0
    = greedy.
    """
    b, t = prompt.shape
    max_len = max_len or (t + max_new_tokens)
    if max_len < t + max_new_tokens:
        raise ValueError(f"max_len {max_len} < prompt {t} + new "
                         f"{max_new_tokens}")
    key = key if key is not None else jax.random.PRNGKey(0)

    caches = init_caches(cfg, b, max_len, qtype=qtype)
    logits, caches = prefill(params, prompt, cfg, caches)
    key, sub = jax.random.split(key)
    first = _sample(logits, sub, temperature)

    # Only the LAST step's logits are returned, so they live in the scan
    # CARRY; stacking (token, logits) per step would allocate an
    # [N, B, vocab] fp32 buffer (~2 GB at B=8/V=32k/N=2k) that competes
    # with the KV caches for HBM for the whole generation.
    def step(carry, _):
        token, position, caches, key, _ = carry
        logits, caches = decode_one(params, token, position, cfg, caches)
        key, sub = jax.random.split(key)
        nxt = _sample(logits, sub, temperature)
        return (nxt, position + 1, caches, key, logits), token

    (_, _, _, _, last_logits), tokens = jax.lax.scan(
        step, (first, jnp.int32(t), caches, key, logits), None,
        length=max_new_tokens)
    # scan stacks along axis 0 → [N, B]; emit [B, T+N]
    out = jnp.concatenate([prompt, tokens.T], axis=1)
    return out, last_logits
