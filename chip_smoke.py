"""Run the attention library and its model once on the GPU, and check them.

    python chip_smoke.py              # kernels, train, serve on one card
    python chip_smoke.py --timings    # kernel-vs-XLA decision timings only
    python chip_smoke.py --cards 4    # ring / sharded paths on four cards only

The default run has three phases, each a function that takes its sizes
(the CPU tests call them small, in interpret mode):

1. kernels: every Pallas kernel of the main path, compiled for the card,
   against the plain fp32 reference (ops/naive.py) at real widths;
2. train: three optax.adam steps of the 271M model at T=4096, and its
   step-0 logits in fp32 against the same model with naive attention;
3. serve: generate() on the 246M GQA model over bf16 and int8 caches,
   and decode_one's logits against prefill's at the same position.

A failed check raises, so any failure exits non-zero. The script refuses
to run without a GPU. Its last line is one JSON object naming the device.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

from cuda_flashattention_tpu.utils.timing import card_lines, time_stats

# Tolerances, as max |got − ref| / max |ref| (bf16 has an 8-bit
# significand: one rounding is ≤ 2^-9 ≈ 2e-3 of the value, and the
# kernels round Q, K, V, P (and dO, dS in the backward) once each).
TOL_BF16_FWD = 1e-2
TOL_BF16_BWD = 2e-2
# fp32 model logits: the kernels' fp32 dots run at full precision and the
# reference pins HIGHEST, so only summation order differs.
TOL_FP32_LOGITS = 1e-3
# int8 cache: per-token absmax quantisation moves K and V by ≤ 0.4 %.
TOL_INT8_LOGITS = 5e-2


def rel_err(got, ref) -> float:
    got = jnp.asarray(got, jnp.float32)
    ref = jnp.asarray(ref, jnp.float32)
    scale = jnp.maximum(jnp.max(jnp.abs(ref)), 1e-30)
    return float(jnp.max(jnp.abs(got - ref)) / scale)


def check(name: str, err: float, tol: float) -> None:
    ok = bool(np.isfinite(err)) and err <= tol
    print(f"  {name:48s} err {err:.3e}  tol {tol:.1e}  "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError(f"{name}: error {err} exceeds {tol}")


def _normal(key, shape, dtype=jnp.bfloat16):
    return jax.random.normal(key, shape, jnp.float32).astype(dtype)


def _repeat_kv(x, group):
    return jnp.repeat(x, group, axis=1) if group > 1 else x


# ---------------------------------------------------------------------------
# Phase 1: kernels against the plain reference
# ---------------------------------------------------------------------------


def _fwd_bwd_case(name, key, *, b, h, hkv, n, d, causal=True, window=0,
                  kv_offset=0, segment_len=0):
    from cuda_flashattention_tpu.ops.attention import flash_attention
    from cuda_flashattention_tpu.ops.naive import (
        naive_attention, naive_attention_backward)

    ks = jax.random.split(key, 4)
    q = _normal(ks[0], (b, h, n, d))
    k = _normal(ks[1], (b, hkv, n, d))
    v = _normal(ks[2], (b, hkv, n, d))
    do = _normal(ks[3], (b, h, n, d))
    seg = None
    if segment_len:
        seg = jnp.broadcast_to(jnp.arange(n, dtype=jnp.int32)
                               // segment_len, (b, n))
    kw = dict(causal=causal, window=window, kv_offset=kv_offset)

    def f(q, k, v):
        return flash_attention(q, k, v, q_segment_ids=seg,
                               kv_segment_ids=seg, **kw)

    o, vjp = jax.jit(lambda q, k, v: jax.vjp(f, q, k, v))(q, k, v)
    dq, dk, dv = jax.jit(vjp)(do)
    group = h // hkv
    kr, vr = _repeat_kv(k, group), _repeat_kv(v, group)
    o_ref, _ = jax.jit(lambda: naive_attention(
        q, kr, vr, q_segment_ids=seg, kv_segment_ids=seg, **kw))()
    check(f"{name} O", rel_err(o, o_ref), TOL_BF16_FWD)
    del o_ref
    rq, rk, rv = jax.jit(lambda: naive_attention_backward(
        q, kr, vr, do, q_segment_ids=seg, kv_segment_ids=seg, **kw))()
    rk = rk.reshape(b, hkv, group, n, d).sum(2)
    rv = rv.reshape(b, hkv, group, n, d).sum(2)
    for g_name, got, ref in (("dQ", dq, rq), ("dK", dk, rk), ("dV", dv, rv)):
        check(f"{name} {g_name}", rel_err(got, ref), TOL_BF16_BWD)


def _quantized_prefill_case(key, qtype, *, b, h, n, d):
    from cuda_flashattention_tpu.ops.naive import naive_attention
    from cuda_flashattention_tpu.ops.quant import (
        flash_attention_quantized, quantize_kv)

    ks = jax.random.split(key, 3)
    q = _normal(ks[0], (b, h, n, d))
    kv = quantize_kv(_normal(ks[1], (b, h, n, d)),
                     _normal(ks[2], (b, h, n, d)), qtype)
    o, _ = jax.jit(lambda q, kv: flash_attention_quantized(
        q, kv, causal=True))(q, kv)
    k_dq, v_dq = kv.dequantize()
    o_ref, _ = jax.jit(lambda: naive_attention(q, k_dq, v_dq,
                                               causal=True))()
    check(f"prefill {qtype} KV n={n} O", rel_err(o, o_ref), TOL_BF16_FWD)


def _decode_reference(q, k, v, lengths, group):
    """Per-sequence fp32 decode over each live prefix."""
    from cuda_flashattention_tpu.ops.naive import naive_attention
    outs = []
    for i, n_live in enumerate(np.asarray(lengths).tolist()):
        o, _ = naive_attention(
            q[i][:, None, :], _repeat_kv(k[i:i + 1, :, :n_live], group)[0],
            _repeat_kv(v[i:i + 1, :, :n_live], group)[0])
        outs.append(o[:, 0])
    return jnp.stack(outs)


def _decode_case(key, qtype, *, b, h, hkv, ctx, d):
    from cuda_flashattention_tpu.ops.decode import decode_attention
    from cuda_flashattention_tpu.ops.quant import quantize_kv

    ks = jax.random.split(key, 3)
    q = _normal(ks[0], (b, h, d))
    k = _normal(ks[1], (b, hkv, ctx, d))
    v = _normal(ks[2], (b, hkv, ctx, d))
    # ragged: a full cache, a one-token sequence, and two partial ones
    lengths = jnp.asarray(
        [ctx, 1, (ctx * 9) // 16 + 7, (ctx * 3) // 4 - 5][:b], jnp.int32)
    scales = {}
    if qtype:
        kv = quantize_kv(k, v, qtype)
        k, v = kv.k_q, kv.v_q
        scales = dict(k_scale=kv.k_scale, v_scale=kv.v_scale)
        k_ref, v_ref = kv.dequantize()
    else:
        k_ref, v_ref = k, v
    o, _ = jax.jit(decode_attention)(q, k, v, lengths, **scales)
    o_ref = _decode_reference(q, k_ref, v_ref, lengths, h // hkv)
    check(f"decode {qtype or 'bf16'} ctx={ctx} B={b} O", rel_err(o, o_ref),
          TOL_BF16_FWD)


def _paged_case(key, *, b, h, hkv, d, page_size, max_pages):
    from cuda_flashattention_tpu.ops.paged import paged_decode_attention

    n_pool = b * max_pages
    ks = jax.random.split(key, 4)
    q = _normal(ks[0], (b, h, d))
    kp = _normal(ks[1], (n_pool, hkv, page_size, d))
    vp = _normal(ks[2], (n_pool, hkv, page_size, d))
    table = jax.random.permutation(ks[3], n_pool).reshape(
        b, max_pages).astype(jnp.int32)
    cap = max_pages * page_size
    lengths = jnp.asarray([cap - page_size // 2, cap // 3 + 1][:b],
                          jnp.int32)
    o, _ = jax.jit(paged_decode_attention)(q, kp, vp, table, lengths)

    def contig(pool):  # [B, Hkv, cap, d] through the table
        return jnp.moveaxis(pool[table], 2, 1).reshape(b, hkv, cap, d)

    o_ref = _decode_reference(q, contig(kp), contig(vp), lengths, h // hkv)
    check(f"paged decode B={b} pages={max_pages}x{page_size} O",
          rel_err(o, o_ref), TOL_BF16_FWD)


def phase_kernels(*, b=1, h=16, hkv_gqa=4, n=4096, d=128, window=1024,
                  ragged_n=4000, kv_offset=300, segment_len=1024,
                  dec_b=4, dec_h=16, dec_hkv=4, dec_ctx=16384,
                  page_size=128, max_pages=8, seed=0):
    print("phase kernels", flush=True)
    key = jax.random.PRNGKey(seed)
    ks = jax.random.split(key, 16)
    _fwd_bwd_case(f"causal B={b} H={h} N={n} d={d}", ks[0], b=b, h=h,
                  hkv=h, n=n, d=d)
    _fwd_bwd_case(f"GQA {h}/{hkv_gqa} causal", ks[1], b=b, h=h,
                  hkv=hkv_gqa, n=n, d=d)
    _fwd_bwd_case(f"window={window}", ks[2], b=b, h=h, hkv=h, n=n, d=d,
                  window=window)
    _fwd_bwd_case(f"ragged N={ragged_n} kv_offset={kv_offset}", ks[3],
                  b=b, h=h, hkv=h, n=ragged_n, d=d, kv_offset=kv_offset)
    _fwd_bwd_case(f"segments of {segment_len}", ks[4], b=b, h=h, hkv=h,
                  n=n, d=d, segment_len=segment_len)
    for i, qtype in enumerate(("int8", "fp8")):
        _quantized_prefill_case(ks[5 + i], qtype, b=b, h=h, n=n, d=d)
    for i, qtype in enumerate((None, "int8", "fp8", "mixed")):
        _decode_case(ks[7 + i], qtype, b=dec_b, h=dec_h, hkv=dec_hkv,
                     ctx=dec_ctx, d=d)
    _paged_case(ks[11], b=2, h=dec_h, hkv=dec_hkv, d=d,
                page_size=page_size, max_pages=max_pages)


# ---------------------------------------------------------------------------
# Phase 2: train
# ---------------------------------------------------------------------------

TRAIN_CFG = dict(vocab_size=32000, d_model=2048, n_layers=4, n_heads=16,
                 n_kv_heads=16, d_head=128, d_ff=5632)
SERVE_CFG = dict(vocab_size=32000, d_model=2048, n_layers=4, n_heads=16,
                 n_kv_heads=4, d_head=128, d_ff=5632)


def _naive_flash_attention(q, k, v, scale=None, causal=False, window=0,
                           kv_offset=0, block_sizes=None,
                           q_segment_ids=None, kv_segment_ids=None):
    """flash_attention's signature over the plain reference."""
    from cuda_flashattention_tpu.ops.naive import naive_attention
    group = q.shape[1] // k.shape[1]
    o, _ = naive_attention(q, _repeat_kv(k, group), _repeat_kv(v, group),
                           scale=scale, causal=causal, window=window,
                           kv_offset=kv_offset, q_segment_ids=q_segment_ids,
                           kv_segment_ids=kv_segment_ids)
    return o.astype(q.dtype)


def fp32_logits(cfg, params, tokens, attention=None):
    """Model logits in fp32 at full matmul precision, optionally with the
    model's attention replaced by `attention` (same signature)."""
    from cuda_flashattention_tpu.models import transformer as tm
    cfg32 = dataclasses.replace(cfg, dtype=jnp.float32)
    params32 = jax.tree_util.tree_map(lambda x: x.astype(jnp.float32),
                                      params)
    saved = tm.flash_attention
    if attention is not None:
        tm.flash_attention = attention
    try:
        with jax.default_matmul_precision("highest"):
            return jax.jit(lambda p, t: tm.forward(p, t, cfg32))(
                params32, tokens)
    finally:
        tm.flash_attention = saved


def phase_train(*, batch=1, seq=4096, steps=3, cfg_kw=None, seed=0):
    import optax
    from cuda_flashattention_tpu.models.transformer import (
        TransformerConfig, init_params, make_train_step)

    cfg = TransformerConfig(max_seq=seq, dtype=jnp.bfloat16,
                            **(cfg_kw or TRAIN_CFG))
    print(f"phase train: L={cfg.n_layers} d={cfg.d_model} ff={cfg.d_ff} "
          f"H={cfg.n_heads} T={seq} B={batch}", flush=True)
    key = jax.random.PRNGKey(seed)
    params = init_params(key, cfg)
    tokens = jax.random.randint(jax.random.PRNGKey(seed + 1), (batch, seq),
                                0, cfg.vocab_size)
    logits = fp32_logits(cfg, params, tokens)
    logits_ref = fp32_logits(cfg, params, tokens, _naive_flash_attention)
    check("train step-0 logits (fp32) vs naive attention",
          rel_err(logits, logits_ref), TOL_FP32_LOGITS)
    del logits, logits_ref

    opt = optax.adam(1e-4)
    step = make_train_step(cfg, opt)
    opt_state = opt.init(params)
    for i in range(steps):
        params, opt_state, loss = step(params, opt_state, tokens)
        loss = float(loss)
        print(f"  step {i} loss {loss:.4f}", flush=True)
        if not np.isfinite(loss):
            raise AssertionError(f"train step {i}: loss {loss}")


# ---------------------------------------------------------------------------
# Phase 3: serve
# ---------------------------------------------------------------------------


def phase_serve(*, batch=8, prompt=512, new=128, cfg_kw=None, seed=0):
    from cuda_flashattention_tpu.models.generate import generate
    from cuda_flashattention_tpu.models.transformer import (
        TransformerConfig, decode_one, init_caches, init_params, prefill)

    cfg = TransformerConfig(max_seq=prompt + new, dtype=jnp.bfloat16,
                            **(cfg_kw or SERVE_CFG))
    print(f"phase serve: L={cfg.n_layers} d={cfg.d_model} H={cfg.n_heads}/"
          f"{cfg.n_kv_heads} B={batch} prompt={prompt} new={new}",
          flush=True)
    params = init_params(jax.random.PRNGKey(seed), cfg)
    tokens = jax.random.randint(jax.random.PRNGKey(seed + 2),
                                (batch, prompt + 1), 0, cfg.vocab_size)
    for qtype in (None, "int8"):
        out, last = generate(params, tokens[:, :prompt], cfg=cfg,
                             max_new_tokens=new, max_len=prompt + new,
                             qtype=qtype)
        out = np.asarray(out)
        ok = (out.shape == (batch, prompt + new)
              and (out[:, :prompt] == np.asarray(tokens[:, :prompt])).all()
              and out.min() >= 0 and out.max() < cfg.vocab_size
              and bool(jnp.all(jnp.isfinite(last))))
        print(f"  generate {qtype or 'bf16'} cache: out {out.shape} "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise AssertionError(f"generate over {qtype or 'bf16'} cache")

    # decode_one at position t against prefill of t+1 tokens, in fp32
    cfg32 = dataclasses.replace(cfg, dtype=jnp.float32)
    params32 = jax.tree_util.tree_map(lambda x: x.astype(jnp.float32),
                                      params)
    max_len = prompt + new
    for qtype, tol in ((None, TOL_FP32_LOGITS), ("int8", TOL_INT8_LOGITS)):
        with jax.default_matmul_precision("highest"):
            _, caches = prefill(params32, tokens[:, :prompt], cfg32,
                                init_caches(cfg32, batch, max_len, qtype))
            logits_d, _ = decode_one(params32, tokens[:, prompt], prompt,
                                     cfg32, caches)
            logits_p, _ = prefill(params32, tokens, cfg32,
                                  init_caches(cfg32, batch, max_len, qtype))
        check(f"decode_one vs prefill at t={prompt} "
              f"({qtype or 'fp32'} cache)", rel_err(logits_d, logits_p), tol)


# ---------------------------------------------------------------------------
# --timings: each kernel against what XLA makes of the plain version
# ---------------------------------------------------------------------------


def _row(name, stats, note=""):
    med, q1, q3 = stats
    print(f"  {name:56s} median {med * 1e3:9.3f} ms  "
          f"[q1 {q1 * 1e3:9.3f}, q3 {q3 * 1e3:9.3f}] {note}", flush=True)
    return {"name": name, "median_ms": med * 1e3, "q1_ms": q1 * 1e3,
            "q3_ms": q3 * 1e3}


def _dpa(implementation):
    """jax.nn.dot_product_attention in this package's [B,H,N,d] layout."""
    def attn(q, k, v, causal=True):
        o = jax.nn.dot_product_attention(
            q.transpose(0, 2, 1, 3), k.transpose(0, 2, 1, 3),
            v.transpose(0, 2, 1, 3), is_causal=causal,
            implementation=implementation)
        return o.transpose(0, 2, 1, 3)
    return attn


def _model_attention(implementation):
    def attn(q, k, v, scale=None, causal=False, window=0, kv_offset=0,
             block_sizes=None, q_segment_ids=None, kv_segment_ids=None):
        del scale, window, kv_offset, block_sizes
        del q_segment_ids, kv_segment_ids
        return _dpa(implementation)(q, k, v, causal=causal)
    return attn


def _jnp_decode(q, k, v, lengths, k_scale=None, v_scale=None, **_):
    """Plain decode: einsum + softmax over the cache in the query dtype,
    fp32 accumulation, the dequant scales applied in the einsums."""
    b, h, d = q.shape
    hkv = k.shape[1]
    qg = q.reshape(b, hkv, h // hkv, d)
    s = jnp.einsum("bhgd,bhnd->bhgn", qg, k.astype(q.dtype),
                   preferred_element_type=jnp.float32)
    if k_scale is not None:
        s = s * k_scale[:, :, None, :]
    s = s / np.sqrt(d)
    live = jnp.arange(k.shape[2])[None, :] < jnp.asarray(lengths)[:, None]
    s = jnp.where(live[:, None, None, :], s, -jnp.inf)
    lse = jax.nn.logsumexp(s, axis=-1)
    p = jnp.exp(s - lse[..., None])
    if v_scale is not None:
        p = p * v_scale[:, :, None, :]
    o = jnp.einsum("bhgn,bhnd->bhgd", p.astype(q.dtype), v.astype(q.dtype),
                   preferred_element_type=jnp.float32)
    return o.reshape(b, h, d).astype(q.dtype), lse.reshape(b, h)


def _try_time(name, fn, *args, **kw):
    """Time fn, or record that the plain version does not fit the card."""
    try:
        return _row(name, time_stats(fn, *args, **kw))
    except jax.errors.JaxRuntimeError as e:
        if "RESOURCE_EXHAUSTED" not in str(e):
            raise
        print(f"  {name:56s} not measured (out of device memory)",
              flush=True)
        return {"name": name, "median_ms": None}


def phase_timings(*, n=16384, h=16, d=128, train_seq=4096, dec_b=4,
                  dec_h=16, dec_hkv=4, ctxs=(16384, 131072), serve_b=8,
                  serve_prompt=512, serve_new=128, repeats=10, seed=0):
    import optax
    from cuda_flashattention_tpu.models import transformer as tm
    from cuda_flashattention_tpu.models.generate import generate
    from cuda_flashattention_tpu.ops import kv_cache
    from cuda_flashattention_tpu.ops.attention import flash_attention
    from cuda_flashattention_tpu.ops.decode import decode_attention
    from cuda_flashattention_tpu.ops.flash_fwd import flash_attention_forward
    from cuda_flashattention_tpu.ops.quant import quantize_kv

    print("phase timings", flush=True)
    rows = []
    ks = jax.random.split(jax.random.PRNGKey(seed), 8)
    q, k, v, do = (_normal(ks[i], (1, h, n, d)) for i in range(4))
    fwd = {
        "pallas-triton": jax.jit(
            lambda q, k, v: flash_attention_forward(q, k, v, causal=True)[0]),
        "xla": jax.jit(lambda q, k, v: _dpa("xla")(q, k, v)),
        "cudnn": jax.jit(lambda q, k, v: _dpa("cudnn")(q, k, v)),
    }
    for name, f in fwd.items():
        rows.append(_try_time(f"fwd causal B=1 H={h} N={n} d={d} {name}",
                              f, q, k, v, repeats=repeats))
    fwd_bwd = {
        "pallas-triton": lambda q, k, v: flash_attention(q, k, v,
                                                         causal=True),
        "xla": _dpa("xla"),
        "cudnn": _dpa("cudnn"),
    }
    for name, f in fwd_bwd.items():
        g = jax.jit(lambda q, k, v, do, f=f: jax.vjp(f, q, k, v)[1](do))
        rows.append(_try_time(f"fwd+bwd causal B=1 H={h} N={n} {name}",
                              g, q, k, v, do, repeats=repeats))
    del q, k, v, do

    # inside the 271M train step
    cfg = tm.TransformerConfig(max_seq=train_seq, dtype=jnp.bfloat16,
                               **TRAIN_CFG)
    params = tm.init_params(jax.random.PRNGKey(seed), cfg)
    tokens = jax.random.randint(ks[4], (1, train_seq), 0, cfg.vocab_size)
    opt = optax.adam(1e-4)
    opt_state = opt.init(params)
    saved = tm.flash_attention
    try:
        for name, attn in (("pallas-triton", saved),
                           ("xla", _model_attention("xla")),
                           ("cudnn", _model_attention("cudnn"))):
            tm.flash_attention = attn
            step = tm.make_train_step(cfg, opt, donate=False)
            rows.append(_try_time(
                f"train step 271M T={train_seq} attention={name}", step,
                params, opt_state, tokens, repeats=repeats))
    finally:
        tm.flash_attention = saved
    del params, opt_state

    # decode at ctx over bf16 and int8 caches
    for ctx in ctxs:
        qd = _normal(ks[5], (dec_b, dec_h, d))
        kc = _normal(ks[6], (dec_b, dec_hkv, ctx, d))
        vc = _normal(ks[7], (dec_b, dec_hkv, ctx, d))
        lengths = jnp.full((dec_b,), ctx, jnp.int32)
        for qtype in (None, "int8"):
            args, kw = (kc, vc), {}
            if qtype:
                kv = quantize_kv(kc, vc, qtype)
                args = (kv.k_q, kv.v_q)
                kw = dict(k_scale=kv.k_scale, v_scale=kv.v_scale)
            for name, f in (("pallas-triton", decode_attention),
                            ("jnp", _jnp_decode)):
                g = jax.jit(lambda q, k, v, ln, kw, f=f: f(q, k, v, ln,
                                                           **kw)[0])
                rows.append(_try_time(
                    f"decode B={dec_b} H={dec_h}/{dec_hkv} ctx={ctx} "
                    f"{qtype or 'bf16'} {name}", g, qd, *args, lengths, kw,
                    repeats=repeats))
        del kc, vc

    # inside generate()
    cfg = tm.TransformerConfig(max_seq=serve_prompt + serve_new,
                               dtype=jnp.bfloat16, **SERVE_CFG)
    params = tm.init_params(jax.random.PRNGKey(seed), cfg)
    prompt = jax.random.randint(ks[4], (serve_b, serve_prompt), 0,
                                cfg.vocab_size)
    saved_attn = kv_cache.decode_attention
    try:
        for name, f in (("pallas-triton", saved_attn), ("jnp", _jnp_decode)):
            kv_cache.decode_attention = f
            jax.clear_caches()  # generate() is jitted: retrace with f
            for qtype in (None, "int8"):
                run = jax.jit(lambda p, t, qt=qtype: generate(
                    p, t, cfg=cfg, max_new_tokens=serve_new,
                    max_len=serve_prompt + serve_new, qtype=qt)[0])
                rows.append(_try_time(
                    f"generate B={serve_b} prompt={serve_prompt} "
                    f"new={serve_new} {qtype or 'bf16'} decode={name}",
                    run, params, prompt, repeats=repeats))
    finally:
        kv_cache.decode_attention = saved_attn
        jax.clear_caches()
    return rows


# ---------------------------------------------------------------------------
# --cards 4: ring prefill, ring decode and the sharded train step
# ---------------------------------------------------------------------------


def phase_cards(*, n_cards=4, n=65536, h=16, d=128, dec_ctx=1 << 20,
                dec_h=16, train_seq=4096, cfg_kw=None, seed=0):
    import optax
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from cuda_flashattention_tpu.models.transformer import (
        TransformerConfig, init_params, make_train_step, param_shardings)
    from cuda_flashattention_tpu.ops.attention import flash_attention
    from cuda_flashattention_tpu.ops.decode import decode_attention
    from cuda_flashattention_tpu.ops.quant import quantize_kv
    from cuda_flashattention_tpu.parallel.ring import (
        ring_attention, ring_decode)

    devices = jax.devices()[:n_cards]
    if len(devices) < n_cards:
        raise RuntimeError(f"need {n_cards} devices, have {len(devices)}")
    print(f"phase cards: {n_cards} x {devices[0].device_kind}", flush=True)
    one = devices[0]
    mesh = Mesh(np.array(devices), ("sp",))
    ks = jax.random.split(jax.random.PRNGKey(seed), 8)

    # ring prefill, fwd + bwd, against one card
    q, k, v, do = (_normal(ks[i], (1, h, n, d)) for i in range(4))
    sp = NamedSharding(mesh, P(None, None, "sp", None))

    def ring_vjp(q, k, v, do):
        o, vjp = jax.vjp(lambda q, k, v: ring_attention(
            q, k, v, mesh, axis_name="sp", causal=True), q, k, v)
        return (o, *vjp(do))

    def one_vjp(q, k, v, do):
        o, vjp = jax.vjp(lambda q, k, v: flash_attention(
            q, k, v, causal=True), q, k, v)
        return (o, *vjp(do))

    got = jax.jit(ring_vjp)(*(jax.device_put(x, sp) for x in (q, k, v, do)))
    ref = jax.jit(one_vjp)(*(jax.device_put(x, one) for x in (q, k, v, do)))
    for name, a, r, tol in zip(("O", "dQ", "dK", "dV"), got, ref,
                               (TOL_BF16_FWD,) + (TOL_BF16_BWD,) * 3):
        check(f"ring N={n} H={h} {name} vs one card",
              rel_err(jax.device_put(a, one), r), tol)
    del q, k, v, do, got, ref

    # ring decode over an int8 cache against one card
    qd = _normal(ks[4], (1, dec_h, d))
    kv = quantize_kv(_normal(ks[5], (1, dec_h, dec_ctx, d)),
                     _normal(ks[6], (1, dec_h, dec_ctx, d)), "int8")
    length = dec_ctx - 1000
    cache_sp = NamedSharding(mesh, P(None, None, "sp", None))
    scale_sp = NamedSharding(mesh, P(None, None, "sp"))
    o_ring, _ = jax.jit(lambda q, kq, vq, ksc, vsc: ring_decode(
        q, kq, vq, length, mesh, axis_name="sp", k_scale=ksc,
        v_scale=vsc))(jax.device_put(qd, NamedSharding(mesh, P())),
                      jax.device_put(kv.k_q, cache_sp),
                      jax.device_put(kv.v_q, cache_sp),
                      jax.device_put(kv.k_scale, scale_sp),
                      jax.device_put(kv.v_scale, scale_sp))
    o_one, _ = jax.jit(lambda q, kq, vq, ksc, vsc: decode_attention(
        q, kq, vq, jnp.full((1,), length, jnp.int32), k_scale=ksc,
        v_scale=vsc))(*(jax.device_put(x, one) for x in (
            qd, kv.k_q, kv.v_q, kv.k_scale, kv.v_scale)))
    check(f"ring_decode int8 ctx={dec_ctx} vs one card",
          rel_err(jax.device_put(o_ring, one), o_one), TOL_BF16_FWD)
    del kv

    # one dp×tp×sp train step (tp=2, sp=2) against one card
    cfg = TransformerConfig(max_seq=train_seq, dtype=jnp.bfloat16,
                            **(cfg_kw or TRAIN_CFG))
    tokens = jax.random.randint(ks[7], (1, train_seq), 0, cfg.vocab_size)
    opt = optax.sgd(1e-3)
    params = jax.device_put(init_params(jax.random.PRNGKey(seed), cfg), one)
    _, _, loss_one = make_train_step(cfg, opt, donate=False)(
        params, opt.init(params), jax.device_put(tokens, one))
    mesh3 = Mesh(np.array(devices).reshape(1, 2, n_cards // 2),
                 ("dp", "tp", "sp"))
    params3 = jax.device_put(params, param_shardings(params, mesh3,
                                                     head_axis="tp"))
    step3 = make_train_step(cfg, opt, donate=False, mesh=mesh3,
                            seq_axis="sp", batch_axis="dp", head_axis="tp")
    _, _, loss3 = step3(params3, opt.init(params3),
                        jax.device_put(tokens, NamedSharding(mesh3,
                                                             P("dp", None))))
    err = abs(float(loss3) - float(loss_one)) / abs(float(loss_one))
    print(f"  train loss one card {float(loss_one):.5f}, dp1 x tp2 x "
          f"sp{n_cards // 2} {float(loss3):.5f}", flush=True)
    check("sharded train step loss vs one card", err, TOL_BF16_FWD)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--timings", action="store_true",
                    help="run only the kernel-vs-XLA decision timings")
    ap.add_argument("--cards", type=int, default=1, choices=(1, 4),
                    help="4: run only the ring / sharded paths")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="chiprun_out/chip_smoke_timings.json",
                    help="where --timings writes its rows")
    opts = ap.parse_args(argv)

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: no GPU (platform {devices[0].platform!r})",
              file=sys.stderr)
        return 2

    from cuda_flashattention_tpu.utils.compile_cache import (
        enable_compile_cache)
    import jaxlib
    cache = enable_compile_cache()
    cards = card_lines()
    for line in cards:
        print(f"card: {line}")
    print(f"jax {jax.__version__} jaxlib {jaxlib.__version__} "
          f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r} "
          f"compile cache {cache}", flush=True)

    t0 = time.perf_counter()
    if opts.cards == 4:
        phase_cards(n_cards=4, seed=opts.seed)
    elif opts.timings:
        rows = phase_timings(seed=opts.seed)
        os.makedirs(os.path.dirname(opts.out) or ".", exist_ok=True)
        with open(opts.out, "w") as f:
            json.dump({"cards": cards, "rows": rows}, f, indent=1)
    else:
        for phase in (phase_kernels, phase_train, phase_serve):
            t = time.perf_counter()
            phase(seed=opts.seed)
            print(f"  ({time.perf_counter() - t:.1f} s)", flush=True)
    print(f"total {time.perf_counter() - t0:.1f} s", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
