"""Benchmark harness — prints ONE JSON line of measurements on the GPU.

Rows: FA2 forward at B=1 H=16 N=16k d=128 over bf16 / int8 / fp8 KV,
causal and windowed; causal prefill at 65k; causal fwd+bwd; the 271M
model's train step (tokens/s, MFU); end-to-end generate() on the 246M
GQA model over bf16 and int8 caches; decode tokens/s over bf16 / int8 /
fp8 / mixed caches at 16k, 131k (MHA and GQA), windowed 131k, and 1M.

Every time is the median of `block_until_ready`-bracketed calls after
warmup (utils/timing.time_stats), with the quartiles beside it. The
card's name and power limit ride in the output, and shares of peak use
the published H100 peaks (utils/timing.PEAKS; an unknown card is an
error). A section that fails is recorded under "errors" and makes the
exit code non-zero; the JSON line is printed either way.

    python bench.py
"""

from __future__ import annotations

import functools
import gc
import json
import sys
import traceback

import jax
import jax.numpy as jnp

from cuda_flashattention_tpu.ops.attention import flash_attention
from cuda_flashattention_tpu.ops.decode import decode_attention
from cuda_flashattention_tpu.ops.flash_fwd import flash_attention_forward
from cuda_flashattention_tpu.ops.quant import quantize_kv
from cuda_flashattention_tpu.utils.compile_cache import enable_compile_cache
from cuda_flashattention_tpu.utils.timing import (
    attention_flops,
    card_lines,
    device_peaks,
    time_stats,
)

B, H, N, D = 1, 16, 16384, 128


class Bench:
    """Incremental result collection; a failed section is recorded."""

    def __init__(self):
        self.rows: dict = {}
        self.errors: dict = {}
        self._keys = iter(jax.random.split(jax.random.PRNGKey(0), 64))

    def mk(self, shape, dtype=jnp.bfloat16):
        # generate on-device: host numpy at these sizes (GBs) is slow
        return jax.random.uniform(next(self._keys), shape, dtype,
                                  -0.5, 0.5)

    def time(self, name, fn, *args, work=None, unit="TFLOP/s", repeats=10):
        """Time jitted fn(*args); record median/quartile seconds and, with
        `work` (FLOPs or tokens per call), the rate at the median."""
        med, q1, q3 = time_stats(jax.jit(fn), *args, repeats=repeats)
        row = {"median_ms": med * 1e3, "q1_ms": q1 * 1e3, "q3_ms": q3 * 1e3}
        if work is not None:
            scale = 1e12 if unit == "TFLOP/s" else 1.0
            row[unit] = work / med / scale
        self.rows[name] = row
        print(f"bench.py: {name}: {row}", file=sys.stderr, flush=True)
        return row

    def section(self, name: str, fn) -> None:
        print(f"bench.py: section [{name}] ...", file=sys.stderr,
              flush=True)
        try:
            fn()
        except Exception as e:  # noqa: BLE001 — recorded, exit non-zero
            print(f"bench.py: section [{name}] FAILED: {e}\n"
                  f"{traceback.format_exc(limit=8)}", file=sys.stderr,
                  flush=True)
            self.errors[name] = f"{type(e).__name__}: {e}"
        gc.collect()


def main() -> int:
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench.py: no GPU (platform {dev.platform!r})",
              file=sys.stderr)
        return 2
    enable_compile_cache()
    peaks = device_peaks(dev)
    bench = Bench()
    mk = bench.mk
    fl = attention_flops(B, H, N, N, D)
    fl_c = attention_flops(B, H, N, N, D, causal=True)

    def fwd(**kw):
        return lambda q, k, v, *sc: flash_attention_forward(
            q, k, v, **kw,
            **(dict(k_scale=sc[0], v_scale=sc[1]) if sc else {}))[0]

    def sec_forward():
        q, k, v = mk((B, H, N, D)), mk((B, H, N, D)), mk((B, H, N, D))
        bench.time("fwd_bf16", fwd(), q, k, v, work=fl)
        bench.time("fwd_causal_bf16", fwd(causal=True), q, k, v, work=fl_c)
        for qt in ("int8", "fp8"):
            kv = quantize_kv(k, v, qt)
            bench.time(f"fwd_{qt}_kv", fwd(), q, kv.k_q, kv.v_q,
                       kv.k_scale, kv.v_scale, work=fl)
        # sliding window: FLOPs of the visible band only — rows 0..W-1
        # see i+1 keys, the rest see W
        win = 4096
        pairs = B * H * (win * (win + 1) / 2 + (N - win) * win)
        bench.time(f"fwd_causal_win{win}_bf16", fwd(causal=True, window=win),
                   q, k, v, work=2.0 * pairs * D * 2)

    def sec_prefill_65k():
        n = 65536
        q, k, v = mk((1, 4, n, D)), mk((1, 4, n, D)), mk((1, 4, n, D))
        bench.time("fwd_causal_65k_bf16", fwd(causal=True), q, k, v,
                   work=attention_flops(1, 4, n, n, D, causal=True),
                   repeats=5)

    def sec_fwd_bwd():
        q, k, v, do = (mk((B, H, N, D)) for _ in range(4))

        def fb(q, k, v, do):
            o, vjp = jax.vjp(lambda q, k, v: flash_attention(
                q, k, v, causal=True), q, k, v)
            return vjp(do)   # all of dQ, dK, dV are outputs
        bench.time("fwd_bwd_causal_bf16", fb, q, k, v, do,
                   work=fl_c + attention_flops(B, H, N, N, D, causal=True,
                                               backward=True))

    def sec_train():
        import optax
        from cuda_flashattention_tpu.models.transformer import (
            TransformerConfig, init_params, make_train_step)
        cfg = TransformerConfig(
            vocab_size=32000, d_model=2048, n_layers=4, n_heads=16,
            n_kv_heads=16, d_head=128, d_ff=5632, max_seq=4096,
            dtype=jnp.bfloat16)
        params = init_params(jax.random.PRNGKey(0), cfg)
        n_params = sum(x.size for x in jax.tree_util.tree_leaves(params))
        tokens = jax.random.randint(jax.random.PRNGKey(1), (1, 4096), 0,
                                    cfg.vocab_size)
        opt = optax.adam(1e-4)
        step = make_train_step(cfg, opt, donate=False)
        row = bench.time("train_step_271m_t4096", step, params,
                         opt.init(params), tokens, work=tokens.size,
                         unit="tokens/s")
        # 6·P matmul FLOPs per token (fwd 2P + bwd 4P) + attention
        flops = (6.0 * n_params * tokens.size
                 + 3 * attention_flops(1, cfg.n_heads, 4096, 4096,
                                       cfg.d_head, causal=True)
                 * cfg.n_layers)
        row["mfu"] = flops / (row["median_ms"] / 1e3) / 1e12 / peaks[
            "peak_tflops"]
        row["params_m"] = n_params / 1e6

    def sec_serving():
        from cuda_flashattention_tpu.models.generate import generate
        from cuda_flashattention_tpu.models.transformer import (
            TransformerConfig, init_params)
        cfg = TransformerConfig(
            vocab_size=32000, d_model=2048, n_layers=4, n_heads=16,
            n_kv_heads=4, d_head=128, d_ff=5632, max_seq=8192,
            dtype=jnp.bfloat16)
        params = init_params(jax.random.PRNGKey(0), cfg)
        bsz, t_prompt, n_new = 8, 512, 128
        prompt = jax.random.randint(jax.random.PRNGKey(2),
                                    (bsz, t_prompt), 0, cfg.vocab_size)
        for qt in (None, "int8"):
            run = functools.partial(
                generate, cfg=cfg, max_new_tokens=n_new,
                max_len=t_prompt + n_new, qtype=qt)
            bench.time(f"generate_246m_b{bsz}_p{t_prompt}_n{n_new}_"
                       f"{qt or 'bf16'}", lambda p, t: run(p, t)[0], params,
                       prompt, work=bsz * n_new, unit="tokens/s", repeats=5)

    db, dh = 4, 16

    def dec(**kw):
        return lambda q, k, v, ln, *sc: decode_attention(
            q, k, v, ln, **kw,
            **(dict(k_scale=sc[0], v_scale=sc[1]) if sc else {}))[0]

    def sec_decode(ctx: int):
        lengths = jnp.full((db,), ctx, jnp.int32)
        for hkv in (dh, dh // 4):
            k, v, q = mk((db, hkv, ctx, D)), mk((db, hkv, ctx, D)), mk(
                (db, dh, D))
            tag = "" if hkv == dh else f"_gqa{dh}x{hkv}"
            bench.time(f"decode_bf16_ctx{ctx}{tag}", dec(), q, k, v,
                       lengths, work=db, unit="tokens/s")
            for qt in ("int8", "fp8", "mixed"):
                kv = quantize_kv(k, v, qt)
                bench.time(f"decode_{qt}_ctx{ctx}{tag}", dec(), q, kv.k_q,
                           kv.v_q, lengths, kv.k_scale, kv.v_scale, work=db,
                           unit="tokens/s")
                del kv
            del k, v

    def sec_decode_windowed():
        ctx, win = 131072, 4096
        k, v, q = mk((db, dh, ctx, D)), mk((db, dh, ctx, D)), mk((db, dh, D))
        lengths = jnp.full((db,), ctx, jnp.int32)
        bench.time(f"decode_bf16_ctx{ctx}_win{win}", dec(window=win), q, k,
                   v, lengths, work=db, unit="tokens/s")
        kv = quantize_kv(k, v, "int8")
        del k, v
        bench.time(f"decode_int8_ctx{ctx}_win{win}", dec(window=win), q,
                   kv.k_q, kv.v_q, lengths, kv.k_scale, kv.v_scale, work=db,
                   unit="tokens/s")

    def sec_decode_1m():
        ctx = 1 << 20
        q = mk((1, dh, D))
        lengths = jnp.full((1,), ctx, jnp.int32)
        sc = jnp.full((1, dh, ctx), 1.0 / 127, jnp.float32)
        k1 = jax.random.randint(jax.random.PRNGKey(7), (1, dh, ctx, D),
                                -127, 128, jnp.int8)
        v1 = jax.random.randint(jax.random.PRNGKey(8), (1, dh, ctx, D),
                                -127, 128, jnp.int8)
        bench.time(f"decode_int8_ctx{ctx}", dec(), q, k1, v1, lengths, sc,
                   sc, work=1, unit="tokens/s", repeats=5)

        # the int8 bit patterns reused as fp8 codes, NaN codes zeroed
        def to_fp8(x):
            u = jax.lax.bitcast_convert_type(x, jnp.uint8)
            u = jnp.where((u & 0x7f) == 0x7f, jnp.uint8(0), u)
            return jax.lax.bitcast_convert_type(u, jnp.float8_e4m3fn)
        v8 = jax.jit(to_fp8)(v1)
        del v1
        bench.time(f"decode_mixed_ctx{ctx}", dec(), q, k1, v8, lengths, sc,
                   sc, work=1, unit="tokens/s", repeats=5)
        k8 = jax.jit(to_fp8)(k1)
        del k1
        bench.time(f"decode_fp8_ctx{ctx}", dec(), q, k8, v8, lengths, sc,
                   sc, work=1, unit="tokens/s", repeats=5)

    bench.section("forward_16k", sec_forward)
    bench.section("prefill_65k", sec_prefill_65k)
    bench.section("fwd_bwd", sec_fwd_bwd)
    bench.section("train_step", sec_train)
    bench.section("serving_e2e", sec_serving)
    jax.clear_caches()
    bench.section("decode_16k", lambda: sec_decode(16384))
    bench.section("decode_131k", lambda: sec_decode(131072))
    bench.section("decode_windowed", sec_decode_windowed)
    bench.section("decode_1m", sec_decode_1m)

    for row in bench.rows.values():
        if "TFLOP/s" in row:
            row["share_of_peak_bf16"] = row["TFLOP/s"] / peaks["peak_tflops"]
    result = {
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "cards": card_lines(),
        "peaks": peaks,
        "timing": "median and quartiles of block_until_ready-bracketed "
                  "calls after warmup (utils/timing.time_stats)",
        "rows": bench.rows,
    }
    if bench.errors:
        result["errors"] = bench.errors
    print(json.dumps(result))
    return 1 if bench.errors else 0


if __name__ == "__main__":
    sys.exit(main())
