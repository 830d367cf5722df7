"""Quantized (FP8 / INT8) KV storage with kernel-fused dequantisation.

The reference is all fp32 and has no quantisation; this module adds
KV-cache quantisation for decode, where attention is bound by memory
bandwidth and halving the KV bytes (int8/fp8 against bf16) directly
scales tokens/s.

Scheme: per-token (per row of K and V, absmax over the head dim) fp32
scales. Dequantisation never materialises in device memory — it is
folded into the kernels' matmuls (ops/flash_fwd.py, ops/decode.py):

    S = (Q · K_qᵀ) ⊙ k_scaleᵀ · sm_scale   (int8/fp8 → bf16 casts are exact)
    O += (P ⊙ v_scaleᵀ) · V_q

Accuracy gates: output vs fp32 naive oracle within 1e-2 at
fp8 (e4m3, 3 mantissa bits) and 1e-3 at int8 (7 significand bits);
enforced by tests/test_quant.py.

Caveat (observed, by construction): when attention *scores* are huge
(|QKᵀ·scale| ≫ 10, i.e. softmax ≈ argmax), ANY K perturbation — including
quantisation — flips winners and the output error is unbounded relative to
fp32. That is inherent to quantising K at degenerate softmax temperatures,
not a property of the fused dequant (which is bit-exact vs materialised
dequantisation up to matmul rounding; see test_kernel_exact_vs_dequantized).
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from cuda_flashattention_tpu.ops.common import BlockSizes
from cuda_flashattention_tpu.ops.flash_fwd import flash_attention_forward

INT8_MAX = 127.0
# float8_e4m3fn: max finite 448.
FP8_MAX = 448.0

_SUPPORTED = ("int8", "fp8", "mixed")


def _qmax(qtype: str) -> float:
    if qtype == "int8":
        return INT8_MAX
    if qtype == "fp8":
        return FP8_MAX
    # "mixed" applies at the K/V-PAIR level (quantize_kv / init_cache /
    # init_paged_cache), never per tensor.
    raise ValueError(
        f"per-tensor qtype must be 'int8' or 'fp8', got {qtype!r}")


def _storage_dtype(qtype: str):
    if qtype == "int8":
        return jnp.int8
    if qtype == "fp8":
        return jnp.float8_e4m3fn
    raise ValueError(
        f"per-tensor qtype must be 'int8' or 'fp8', got {qtype!r}")


def _pair_qtypes(qtype: str) -> Tuple[str, str]:
    """Resolve a pair-level qtype to (k_qtype, v_qtype)."""
    if qtype not in _SUPPORTED:
        raise ValueError(f"qtype must be one of {_SUPPORTED}, got {qtype!r}")
    return ("int8", "fp8") if qtype == "mixed" else (qtype, qtype)


@jax.tree_util.register_pytree_node_class
class QuantizedKV:
    """A quantized K/V pair: values [B,H,N,d] (int8|fp8) + scales [B,H,N].

    The cache-manager payload: K/V blocks live quantized in device memory
    with per-token scales; kernels consume them directly.
    """

    def __init__(self, k_q, k_scale, v_q, v_scale):
        self.k_q, self.k_scale = k_q, k_scale
        self.v_q, self.v_scale = v_q, v_scale

    @property
    def shape(self):
        return self.k_q.shape

    @property
    def qtype(self) -> str:
        kt = "int8" if self.k_q.dtype == jnp.int8 else "fp8"
        vt = "int8" if self.v_q.dtype == jnp.int8 else "fp8"
        return kt if kt == vt else "mixed"

    def dequantize(self) -> Tuple[jnp.ndarray, jnp.ndarray]:
        """Materialised fp32 K/V — for testing only; kernels never do this."""
        k = self.k_q.astype(jnp.float32) * self.k_scale[..., None]
        v = self.v_q.astype(jnp.float32) * self.v_scale[..., None]
        return k, v

    def tree_flatten(self):
        return (self.k_q, self.k_scale, self.v_q, self.v_scale), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)


@functools.partial(jax.jit, static_argnames=("qtype", "axis"))
def quantize_tensor(x: jnp.ndarray, qtype: str = "int8",
                    axis: int = -1) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Absmax-quantize along `axis`; returns (values, scale with axis dropped).

    A handful of fused elementwise ops under jit (jitted here so the fp32
    intermediates fuse instead of materialising at cache scale) — no
    standalone kernel needed; the performance-critical direction (dequant)
    lives inside the attention kernels.
    """
    x = x.astype(jnp.float32)
    qmax = _qmax(qtype)
    absmax = jnp.max(jnp.abs(x), axis=axis, keepdims=True)
    scale = jnp.maximum(absmax, 1e-12) / qmax
    y = x / scale
    if qtype == "int8":
        q = jnp.clip(jnp.round(y), -INT8_MAX, INT8_MAX).astype(jnp.int8)
    else:
        q = y.astype(jnp.float8_e4m3fn)
    return q, jnp.squeeze(scale, axis=axis)


def quantize_kv(k: jnp.ndarray, v: jnp.ndarray,
                qtype: str = "int8") -> QuantizedKV:
    """Quantize K/V [B,H,N,d] with per-token (row) scales.

    `qtype="mixed"` stores K int8 and V fp8: int8's uniform grid suits
    K, while e4m3's relative precision suits heavy-tailed value
    distributions (real attention V activations; on uniform test data
    int8 measures tighter — see the per-mode gates in
    tests/test_quant.py). The kernels cast each array by its own dtype."""
    kt, vt = _pair_qtypes(qtype)
    k_q, k_scale = quantize_tensor(k, kt)
    v_q, v_scale = quantize_tensor(v, vt)
    return QuantizedKV(k_q, k_scale, v_q, v_scale)


def flash_attention_quantized(
    q: jnp.ndarray,
    kv: QuantizedKV,
    scale: Optional[float] = None,
    causal: bool = False,
    kv_offset: int = 0,
    block_sizes: Optional[BlockSizes] = None,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """FA2 forward over a quantized KV pair; dequant fused in-kernel.

    Inference path (no VJP): the backward runs on unquantized tensors.
    Returns (O, LSE) like flash_attention_forward.
    """
    return flash_attention_forward(
        q, kv.k_q, kv.v_q, scale=scale, causal=causal, kv_offset=kv_offset,
        block_sizes=block_sizes, k_scale=kv.k_scale, v_scale=kv.v_scale)
