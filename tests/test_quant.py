"""Quantized-KV accuracy gates — the FP8/INT8 path.

Gates: attention output vs the fp32 naive oracle within 1e-2 at fp8 and
1e-3 at int8 (the reference has no quantisation; these are the
framework's own bars). Also checks the kernel is EXACT w.r.t.
dequantised inputs — isolating fused-dequant correctness from
quantisation noise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cuda_flashattention_tpu.ops.flash_fwd import flash_attention_forward
from cuda_flashattention_tpu.ops.naive import naive_attention
from cuda_flashattention_tpu.ops.quant import (
    QuantizedKV,
    flash_attention_quantized,
    quantize_kv,
    quantize_tensor,
)
from cuda_flashattention_tpu.utils.testing import (
    assert_close,
    max_abs_diff,
    random_qkv,
)

@pytest.mark.parametrize("qtype,tol", [("int8", 5e-3), ("fp8", 4e-2)])
def test_quantize_roundtrip(qtype, tol):
    x = jnp.asarray(np.random.default_rng(0).uniform(-2, 2, (4, 64)),
                    jnp.float32)
    q, scale = quantize_tensor(x, qtype)
    x_hat = q.astype(jnp.float32) * scale[..., None]
    assert_close(x_hat, x, 2 * tol, f"roundtrip {qtype}")


@pytest.mark.parametrize("qtype", ["int8", "fp8", "mixed"])
def test_kernel_exact_vs_dequantized(qtype):
    """The fused-dequant kernel must equal the unquantized kernel run on
    the materialised dequantised K/V — any extra error would mean the
    folding itself is wrong."""
    q, k, v = random_qkv(1, 2, 256, 256, 64)
    kv = quantize_kv(k, v, qtype)
    k_deq, v_deq = kv.dequantize()
    o_fused, lse_fused = flash_attention_quantized(q, kv)
    o_ref, lse_ref = flash_attention_forward(q, k_deq, v_deq)
    assert_close(o_fused, o_ref, 1e-5, f"O fused-vs-dequant {qtype}")
    assert_close(lse_fused, lse_ref, 1e-4,
                 f"LSE fused-vs-dequant {qtype}")


@pytest.mark.parametrize("qtype,tol", [("int8", 1e-3), ("fp8", 1e-2),
                                       ("mixed", 5e-3)])
def test_accuracy_gate_vs_oracle(qtype, tol):
    """Gate: 1e-3 @ int8, 1e-2 @ fp8 vs the fp32 naive oracle
    (seq=512, d=64 — the reference's canonical forward shape). "mixed"
    (int8 K / fp8 V) sits between: int8-class score noise, fp8-class V
    noise."""
    q, k, v = random_qkv(1, 1, 512, 512, 64)
    kv = quantize_kv(k, v, qtype)
    o, _ = flash_attention_quantized(q, kv)
    o_ref, _ = naive_attention(q, k, v)
    d = max_abs_diff(o, o_ref)
    assert d < tol, f"{qtype}: max diff {d:.2e} >= gate {tol}"


@pytest.mark.parametrize("qtype", ["int8", "fp8", "mixed"])
def test_causal_quantized(qtype):
    q, k, v = random_qkv(1, 2, 128, 128, 64)
    kv = quantize_kv(k, v, qtype)
    o, _ = flash_attention_quantized(q, kv, causal=True)
    o_ref, _ = naive_attention(q, k, v, causal=True)
    # mixed carries fp8-class V noise (V errors land directly in O)
    tol = 2e-2 if qtype in ("fp8", "mixed") else 2e-3
    assert_close(o, o_ref, tol, f"O causal {qtype}")


def test_gqa_quantized():
    q, _, _ = random_qkv(1, 4, 128, 128, 64)
    _, k, v = random_qkv(1, 2, 128, 128, 64, seed=9)
    kv = quantize_kv(k, v, "int8")
    o, _ = flash_attention_quantized(q, kv)
    o_ref, _ = naive_attention(q, jnp.repeat(k, 2, 1), jnp.repeat(v, 2, 1))
    assert_close(o, o_ref, 2e-3, "O GQA int8")


def test_non_divisible_quantized():
    q, k, v = random_qkv(1, 1, 100, 200, 32)
    kv = quantize_kv(k, v, "int8")
    o, _ = flash_attention_quantized(q, kv)
    o_ref, _ = naive_attention(q, k, v)
    assert_close(o, o_ref, 2e-3, "O ragged int8")


def test_quantized_kv_is_pytree():
    k = jnp.zeros((1, 1, 8, 8), jnp.int8)
    s = jnp.ones((1, 1, 8), jnp.float32)
    kv = QuantizedKV(k, s, k, s)
    leaves = jax.tree_util.tree_leaves(kv)
    assert len(leaves) == 4
    kv2 = jax.tree_util.tree_map(lambda x: x, kv)
    assert isinstance(kv2, QuantizedKV)
    assert kv2.qtype == "int8"


@pytest.mark.parametrize("storage", [jnp.int8, jnp.float8_e4m3fn],
                         ids=["int8", "fp8"])
def test_in_kernel_cast_is_exact(storage):
    """The kernels cast K/V tiles from storage to bf16 with a plain
    astype. Every int8 and every finite e4m3 code is exactly a bf16
    value (bf16 has 8 significand bits and e4m3's exponent range), so
    the cast adds no error before the per-token scale."""
    codes = np.arange(256, dtype=np.uint8)
    x = jax.lax.bitcast_convert_type(jnp.asarray(codes), storage)
    as_bf16 = np.asarray(x.astype(jnp.bfloat16).astype(jnp.float32))
    exact = np.asarray(x.astype(jnp.float32))
    finite = np.isfinite(exact)
    assert (as_bf16[finite] == exact[finite]).all()


@pytest.mark.parametrize("qtype", ["int8", "fp8", "mixed"])
def test_quantized_sharp_softmax_gqa(qtype):
    """A sharpened softmax (×6 scores) with GQA and an outlier K token,
    which amplifies any dequant-folding error: the fused kernel must
    still equal the oracle on the dequantized values, and the reference
    must be far from the uniform average of V (so a degenerate kernel
    cannot pass vacuously)."""
    q, k, v = random_qkv(1, 4, 96, 130, 32, seed=97, dtype=jnp.float32)
    q = q * 6.0
    k2, v2 = k[:, :2] * 2.0, v[:, :2]
    k2 = k2.at[:, :, 7].set(k2[:, :, 7] * 4.0)
    kv = quantize_kv(k2, v2, qtype)
    kd, vd = kv.dequantize()
    for causal in (False, True):
        o, lse = flash_attention_quantized(q, kv, causal=causal)
        o_ref, lse_ref = naive_attention(
            q, jnp.repeat(kd, 2, 1), jnp.repeat(vd, 2, 1), causal=causal)
        uni = jnp.mean(jnp.repeat(vd, 2, 1), axis=2, keepdims=True)
        assert float(jnp.max(jnp.abs(o_ref - uni))) > 0.1
        assert_close(o, o_ref, 1e-4, f"{qtype} O causal={causal}")
        assert_close(lse, lse_ref, 1e-4, f"{qtype} LSE causal={causal}")


def test_mixed_is_pair_level_only():
    """"mixed" is a K/V-PAIR qtype: the per-tensor API must reject it
    with an error that does not claim it is per-tensor-supported (review
    r3: the old message said "must be one of (... 'mixed')" while
    raising on 'mixed')."""
    from cuda_flashattention_tpu.ops.quant import _storage_dtype

    x = jnp.ones((2, 4, 8))
    with pytest.raises(ValueError, match="per-tensor"):
        quantize_tensor(x, "mixed")
    with pytest.raises(ValueError, match="per-tensor"):
        _storage_dtype("mixed")
    # pair level: fine
    kv = quantize_kv(x, x, "mixed")
    assert kv.k_q.dtype == jnp.int8
    assert kv.v_q.dtype == jnp.float8_e4m3fn
    assert kv.qtype == "mixed"
