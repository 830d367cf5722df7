"""Flagship model: a decoder-only transformer built on the framework's
attention kernels.

The reference has NO model (it is a kernel ladder, SURVEY.md: "no Python
API, no model, no training loop"); this flagship exists because the north
star is an attention *inference/training engine*, and a real model is what
exercises the kernels end-to-end: causal FA2 fwd+bwd for training, the
quantized KV cache + decode kernel for generation, and ring attention +
data parallelism for the multi-chip path.

Pure-JAX pytree parameters (no framework dependency), bf16-friendly,
RMSNorm + RoPE + SwiGLU — the standard modern decoder block, kept small
and explicit so kernels stay the focus.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from cuda_flashattention_tpu.ops.attention import flash_attention
from cuda_flashattention_tpu.ops.common import BlockSizes
from cuda_flashattention_tpu.ops.kv_cache import (
    KVCache,
    append as cache_append,
    decode_step,
    init_cache,
)
from cuda_flashattention_tpu.parallel.ring import ring_attention


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32000
    d_model: int = 512
    n_layers: int = 4
    n_heads: int = 8
    n_kv_heads: int = 8
    d_head: int = 64
    d_ff: int = 1408
    max_seq: int = 2048
    rope_theta: float = 10000.0
    window: int = 0  # 0 = full causal; else sliding-window attention
    dtype: Any = jnp.bfloat16

    @property
    def d_q(self) -> int:
        return self.n_heads * self.d_head

    @property
    def d_kv(self) -> int:
        return self.n_kv_heads * self.d_head


Params = Dict[str, Any]


def init_params(key: jax.Array, cfg: TransformerConfig) -> Params:
    """He/Glorot-ish init; params are a plain nested-dict pytree."""
    keys = jax.random.split(key, 2 + cfg.n_layers)

    def dense(k, fan_in, shape):
        return (jax.random.normal(k, shape, jnp.float32)
                / np.sqrt(fan_in)).astype(cfg.dtype)

    layers = []
    for i in range(cfg.n_layers):
        lk = jax.random.split(keys[2 + i], 7)
        layers.append(dict(
            attn_norm=jnp.ones((cfg.d_model,), cfg.dtype),
            wq=dense(lk[0], cfg.d_model, (cfg.d_model, cfg.d_q)),
            wk=dense(lk[1], cfg.d_model, (cfg.d_model, cfg.d_kv)),
            wv=dense(lk[2], cfg.d_model, (cfg.d_model, cfg.d_kv)),
            wo=dense(lk[3], cfg.d_q, (cfg.d_q, cfg.d_model)),
            mlp_norm=jnp.ones((cfg.d_model,), cfg.dtype),
            w_gate=dense(lk[4], cfg.d_model, (cfg.d_model, cfg.d_ff)),
            w_up=dense(lk[5], cfg.d_model, (cfg.d_model, cfg.d_ff)),
            w_down=dense(lk[6], cfg.d_ff, (cfg.d_ff, cfg.d_model)),
        ))
    return dict(
        # tied embedding/unembedding: 1/sqrt(d_model) keeps the INITIAL
        # logits at unit variance through the tied head (fan_in=1 gave
        # N(0,1) embeddings -> logits std ~sqrt(d_model) ~ 45 and a
        # saturated initial softmax — review r4)
        embed=dense(keys[0], cfg.d_model, (cfg.vocab_size, cfg.d_model)),
        final_norm=jnp.ones((cfg.d_model,), cfg.dtype),
        layers=layers,
    )


def rms_norm(x: jnp.ndarray, w: jnp.ndarray, eps: float = 1e-6):
    xf = x.astype(jnp.float32)
    inv = jax.lax.rsqrt(jnp.mean(xf * xf, axis=-1, keepdims=True) + eps)
    return (xf * inv).astype(x.dtype) * w


def rope(x: jnp.ndarray, positions: jnp.ndarray, theta: float):
    """Rotary embedding: x [B, T, H, d], positions [T] (global indices —
    correct under sequence sharding because callers pass global positions
    and XLA slices them with the activations)."""
    d = x.shape[-1]
    freqs = theta ** (-jnp.arange(0, d, 2, dtype=jnp.float32) / d)
    angles = positions[:, None].astype(jnp.float32) * freqs[None, :]
    cos = jnp.cos(angles)[None, :, None, :]
    sin = jnp.sin(angles)[None, :, None, :]
    x1, x2 = jnp.split(x.astype(jnp.float32), 2, axis=-1)
    out = jnp.concatenate([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                          axis=-1)
    return out.astype(x.dtype)


def _attention_block(layer: Params, x: jnp.ndarray, cfg: TransformerConfig,
                     positions: jnp.ndarray,
                     mesh: Optional[Mesh], seq_axis: Optional[str],
                     batch_axis: Optional[str], head_axis: Optional[str],
                     block_sizes: Optional[BlockSizes]) -> jnp.ndarray:
    b, t, _ = x.shape
    h = rms_norm(x, layer["attn_norm"])
    q = (h @ layer["wq"]).reshape(b, t, cfg.n_heads, cfg.d_head)
    k = (h @ layer["wk"]).reshape(b, t, cfg.n_kv_heads, cfg.d_head)
    v = (h @ layer["wv"]).reshape(b, t, cfg.n_kv_heads, cfg.d_head)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)

    qt = q.transpose(0, 2, 1, 3)
    kt = k.transpose(0, 2, 1, 3)
    vt = v.transpose(0, 2, 1, 3)
    if mesh is not None and seq_axis is not None:
        # sequence-parallel training path: ring attention over the mesh
        # (GQA handled natively by the flash kernels inside the ring; a
        # sliding window terminates the ring after ceil(W/L)+1 hops)
        o = ring_attention(qt, kt, vt, mesh, axis_name=seq_axis,
                           causal=True, window=cfg.window,
                           batch_axis=batch_axis,
                           head_axis=head_axis, block_sizes=block_sizes)
    else:
        o = flash_attention(qt, kt, vt, causal=True, window=cfg.window,
                            block_sizes=block_sizes)
    o = o.transpose(0, 2, 1, 3).reshape(b, t, cfg.d_q)
    return x + (o @ layer["wo"]).astype(x.dtype)


def _mlp_block(layer: Params, x: jnp.ndarray) -> jnp.ndarray:
    h = rms_norm(x, layer["mlp_norm"])
    gated = jax.nn.silu((h @ layer["w_gate"]).astype(jnp.float32))
    up = (h @ layer["w_up"]).astype(jnp.float32)
    return x + ((gated * up).astype(x.dtype) @ layer["w_down"]).astype(
        x.dtype)


def forward(
    params: Params,
    tokens: jnp.ndarray,
    cfg: TransformerConfig,
    mesh: Optional[Mesh] = None,
    seq_axis: Optional[str] = None,
    batch_axis: Optional[str] = None,
    head_axis: Optional[str] = None,
    block_sizes: Optional[BlockSizes] = None,
) -> jnp.ndarray:
    """Causal LM forward: tokens [B, T] → logits [B, T, V].

    With mesh+seq_axis, attention runs sequence-parallel (ring) while the
    token-local layers (norm/FFN/proj) stay under GSPMD propagation.
    `head_axis` adds tensor parallelism: attention heads (and, via
    param_shardings, the FFN hidden dim) shard over that mesh axis —
    heads are independent, so the ring code is unchanged (the shard_map
    specs widen, parallel/ring.py)."""
    b, t = tokens.shape
    x = params["embed"][tokens].astype(cfg.dtype)
    positions = jnp.arange(t)
    for layer in params["layers"]:
        x = _attention_block(layer, x, cfg, positions, mesh, seq_axis,
                             batch_axis, head_axis, block_sizes)
        x = _mlp_block(layer, x)
    x = rms_norm(x, params["final_norm"])
    return (x @ params["embed"].T).astype(jnp.float32)


def loss_fn(params: Params, tokens: jnp.ndarray, cfg: TransformerConfig,
            **fwd_kw) -> jnp.ndarray:
    """Next-token cross entropy (mean over all positions)."""
    logits = forward(params, tokens, cfg, **fwd_kw)
    targets = jnp.roll(tokens, -1, axis=1)
    logp = jax.nn.log_softmax(logits, axis=-1)
    nll = -jnp.take_along_axis(logp, targets[..., None], axis=-1)[..., 0]
    # drop the wrapped-around last position
    return nll[:, :-1].mean()


def make_train_step(cfg: TransformerConfig, optimizer, donate: bool = True,
                    **fwd_kw):
    """Build a jitted SGD/optax train step. `donate=True` donates
    params/opt_state for in-place HBM updates (callers must then thread
    the RETURNED params/opt_state; re-calling with consumed buffers is a
    backend error — set donate=False for benchmarking harnesses that
    replay from a saved x0)."""

    def train_step(params, opt_state, tokens):
        loss, grads = jax.value_and_grad(
            functools.partial(loss_fn, cfg=cfg, **fwd_kw))(params, tokens)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = jax.tree_util.tree_map(
            lambda p, u: (p + u).astype(p.dtype), params, updates)
        return params, opt_state, loss

    return jax.jit(train_step, donate_argnums=(0, 1) if donate else ())


# ---------------------------------------------------------------------------
# Inference: prefill + decode over the quantized KV cache
# ---------------------------------------------------------------------------

def init_caches(cfg: TransformerConfig, batch: int, max_len: int,
                qtype: Optional[str] = None) -> Tuple[KVCache, ...]:
    return tuple(
        init_cache(batch, cfg.n_kv_heads, max_len, cfg.d_head, qtype=qtype,
                   dtype=cfg.dtype)
        for _ in range(cfg.n_layers))


def prefill(params: Params, tokens: jnp.ndarray, cfg: TransformerConfig,
            caches: Tuple[KVCache, ...],
            block_sizes: Optional[BlockSizes] = None):
    """Run the prompt through the model, filling the caches.
    Returns (logits_last [B, V], caches).

    Delegates to prefill_chunk at start=0 — whole-prompt prefill IS the
    single-chunk case (the prefix branch is dead at start 0), and one
    implementation keeps the per-layer QKV/rope/attention plumbing from
    diverging across copies (review r4)."""
    return prefill_chunk(params, tokens, 0, cfg, caches,
                         block_sizes=block_sizes)


def prefill_chunk(params: Params, tokens: jnp.ndarray, start: int,
                  cfg: TransformerConfig, caches: Tuple[KVCache, ...],
                  block_sizes: Optional[BlockSizes] = None):
    """Prefill one chunk of C tokens starting at static position `start`:
    each chunk attends the already-cached prefix (through the
    fused-dequant kernel when the cache is quantized) plus itself
    causally, and the two partials merge exactly in log space
    (parallel.ring.combine_partials). Peak score memory is O(C·ctx) per
    chunk instead of O(T²) — the chunked-prefill serving pattern.

    Returns (logits_last [B, V], caches)."""
    from cuda_flashattention_tpu.ops.flash_fwd import flash_attention_forward
    from cuda_flashattention_tpu.parallel.ring import combine_partials

    b, c = tokens.shape
    x = params["embed"][tokens].astype(cfg.dtype)
    positions = jnp.arange(start, start + c)
    new_caches = []
    for layer, cache in zip(params["layers"], caches):
        h = rms_norm(x, layer["attn_norm"])
        q = (h @ layer["wq"]).reshape(b, c, cfg.n_heads, cfg.d_head)
        k = (h @ layer["wk"]).reshape(b, c, cfg.n_kv_heads, cfg.d_head)
        v = (h @ layer["wv"]).reshape(b, c, cfg.n_kv_heads, cfg.d_head)
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
        qt = q.transpose(0, 2, 1, 3)
        kt = k.transpose(0, 2, 1, 3)
        vt = v.transpose(0, 2, 1, 3)
        cache = cache_append(cache, kt, vt)
        new_caches.append(cache)
        # self-attention within the chunk: Q and K are both chunk-local,
        # so this is plain local causal (with the model's sliding window
        # if set — local and global window masks coincide because rows
        # and cols share the `start` offset)
        o_new, lse_new = flash_attention_forward(
            qt, kt, vt, causal=True, window=cfg.window,
            block_sizes=block_sizes, out_dtype=jnp.float32)
        if start > 0:
            # cached prefix, read in storage dtype with dequant fused
            # into the kernel when quantized. Without a window the whole
            # prefix is visible (causal=False). With one, only keys in
            # (g−W, start) matter: slice the cache to [lo, start) and
            # express the global band as causal+window with
            # kv_offset = start − lo (chunk row r is global start+r =
            # slice-relative (start−lo)+r; prefix cols are all causally
            # visible, and the window cut col > row − W is exactly the
            # kernel's mask). Rows whose window misses the prefix come
            # back LSE=−inf and drop out of the log-space combine.
            lo = max(0, start - cfg.window) if cfg.window else 0
            ks = (cache.k_scale[:, :, lo:start] if cache.quantized
                  else None)
            vs = (cache.v_scale[:, :, lo:start] if cache.quantized
                  else None)
            o_old, lse_old = flash_attention_forward(
                qt, cache.k[:, :, lo:start], cache.v[:, :, lo:start],
                k_scale=ks, v_scale=vs,
                causal=bool(cfg.window), window=cfg.window,
                kv_offset=start - lo,
                block_sizes=block_sizes, out_dtype=jnp.float32)
            o_c, _ = combine_partials(o_old, lse_old, o_new, lse_new)
        else:
            o_c = o_new
        o = o_c.astype(cfg.dtype).transpose(0, 2, 1, 3).reshape(
            b, c, cfg.d_q)
        x = x + (o @ layer["wo"]).astype(x.dtype)
        x = _mlp_block(layer, x)
    x = rms_norm(x, params["final_norm"])
    logits = (x[:, -1] @ params["embed"].T).astype(jnp.float32)
    return logits, tuple(new_caches)


def prefill_chunked(params: Params, tokens: jnp.ndarray,
                    cfg: TransformerConfig, caches: Tuple[KVCache, ...],
                    chunk: int,
                    block_sizes: Optional[BlockSizes] = None):
    """Prefill a long prompt in fixed-size chunks (last chunk may be
    shorter). Equivalent to `prefill` but with bounded per-step memory;
    chunk boundaries are static so every step jits with static shapes."""
    b, t = tokens.shape
    logits = None
    for s in range(0, t, chunk):
        logits, caches = prefill_chunk(
            params, tokens[:, s:s + chunk], s, cfg, caches,
            block_sizes=block_sizes)
    return logits, caches


def decode_one(params: Params, token: jnp.ndarray, position,
               cfg: TransformerConfig, caches: Tuple[KVCache, ...]):
    """One autoregressive step: token [B] → (logits [B, V], caches).
    Attention reads the (possibly quantized) caches via the decode
    kernel (ops/decode.py)."""
    b = token.shape[0]
    x = params["embed"][token].astype(cfg.dtype)  # [B, D]
    positions = jnp.full((1,), position, jnp.int32)
    new_caches = []
    for layer, cache in zip(params["layers"], caches):
        h = rms_norm(x, layer["attn_norm"])
        q = (h @ layer["wq"]).reshape(b, 1, cfg.n_heads, cfg.d_head)
        k = (h @ layer["wk"]).reshape(b, 1, cfg.n_kv_heads, cfg.d_head)
        v = (h @ layer["wv"]).reshape(b, 1, cfg.n_kv_heads, cfg.d_head)
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
        cache = cache_append(cache, k.transpose(0, 2, 1, 3),
                             v.transpose(0, 2, 1, 3))
        new_caches.append(cache)
        # q[:, 0] is already (B, H, d) — the decode kernel's layout
        o, _ = decode_step(q[:, 0], cache, window=cfg.window)
        x = x + (o.reshape(b, cfg.d_q) @ layer["wo"]).astype(x.dtype)
        x = _mlp_block(layer, x[:, None, :])[:, 0]
    x = rms_norm(x, params["final_norm"])
    logits = (x @ params["embed"].T).astype(jnp.float32)
    return logits, tuple(new_caches)


def pipeline_forward(
    params: Params,
    tokens: jnp.ndarray,
    cfg: TransformerConfig,
    mesh: Mesh,
    n_micro: int,
    pp_axis: str = "pp",
    batch_axis: Optional[str] = None,
) -> jnp.ndarray:
    """Causal LM forward with the layer stack run as a GPipe pipeline
    over `pp_axis` (parallel/pipeline.py): stage s holds layers
    [s·L/S, (s+1)·L/S); embedding/unembedding stay replicated. Equals
    `forward` exactly; composes with a dp `batch_axis`."""
    from cuda_flashattention_tpu.parallel.pipeline import (
        gpipe_spmd, stack_stage_params)

    b, t = tokens.shape
    x = params["embed"][tokens].astype(cfg.dtype)
    positions = jnp.arange(t)
    # training loops should stack ONCE at init (stack_stage_params +
    # stage_param_sharding) and pass the stacked pytree through — the
    # list path below re-concatenates every call
    stacked = (params["layers"] if not isinstance(params["layers"], list)
               else stack_stage_params(params["layers"]))

    def stage_fn(stage_layers, x):
        n_local = jax.tree_util.tree_leaves(stage_layers)[0].shape[0]
        for i in range(n_local):
            layer = jax.tree_util.tree_map(lambda w: w[i], stage_layers)
            x = _attention_block(layer, x, cfg, positions, None, None,
                                 None, None, None)
            x = _mlp_block(layer, x)
        return x

    x = gpipe_spmd(stage_fn, stacked, x, mesh, n_micro=n_micro,
                   axis_name=pp_axis, batch_axis=batch_axis)
    x = rms_norm(x, params["final_norm"])
    return (x @ params["embed"].T).astype(jnp.float32)


def param_shardings(params: Params, mesh: Mesh,
                    batch_axis: str = "dp",
                    head_axis: Optional[str] = None) -> Params:
    """Parameter shardings. Without `head_axis`: fully replicated
    (data-parallel baseline). With it: Megatron-style tensor parallelism —
    attention QKV/O shard on the head dimension and the FFN shards on its
    hidden dimension, so each tp rank holds 1/tp of every layer's weights
    and the only cross-rank traffic is the (XLA-inserted) output
    reductions."""
    rep = NamedSharding(mesh, P())
    if head_axis is None:
        return jax.tree_util.tree_map(lambda _: rep, params)
    col = NamedSharding(mesh, P(None, head_axis))   # output-dim sharded
    row = NamedSharding(mesh, P(head_axis, None))   # input-dim sharded
    layer_spec = dict(
        attn_norm=rep, wq=col, wk=col, wv=col, wo=row,
        mlp_norm=rep, w_gate=col, w_up=col, w_down=row,
    )
    return dict(
        embed=rep,
        final_norm=rep,
        layers=[dict(layer_spec) for _ in params["layers"]],
    )
