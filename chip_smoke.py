#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on the GPU.

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` (on PATH or in /usr/local/cuda/bin) and the
checkout's ``src/``; imports nothing of JAX or of the JAX package.  Phases,
each of which raises on failure (nothing is caught):

1. the card's name and power limit, the torch/CUDA versions, and the
   build of all three kernels from ``src/repro_torch/kernels/csrc``
   (nvcc, sm_90a, all sources at once);
2. each kernel against its plain PyTorch version at the serving paths'
   shapes (attention at smollm-135m's head_dim 64 / group 3 and
   deepseek-moe-16b's head_dim 128 / group 1; the grouped matmul at
   deepseek's prefill and decode expert shapes and a ragged one), fp32
   (tight) and bf16 (one bf16 ulp), with its time, the plain version's
   time, the time of the one PyTorch call that computes the same
   function where there is one, and its bound on the H100;
3. the serving path of smollm-135m at full width (30 layers, vocab 49152,
   bf16, random weights from a seed): (a) the CLI entry point, (b) the
   engine over the batched executor with mixed prompt lengths, and (c)
   kernel-vs-plain logits of the full model's prefill and first decode
   step;
4. the serving path of deepseek-moe-16b at full published width (28
   layers, d 2048, 64 routed top-6 + 2 shared experts, first layer
   dense, vocab 102400) with bf16 params (the reference's serve_bf16
   variant; random weights drawn on the card from a seed): (a) the
   engine over ``make_executor``, rows admitting and detaching
   mid-flight, and (b) kernel-vs-plain logits with all three kernels.

The launch counters are zeroed before each serving run and must read,
per prefill, num_layers flash launches and 3 x (num_layers -
first_k_dense) grouped-matmul launches (MoE only), and per decode step
num_layers paged launches and the same grouped-matmul count.

Prints one JSON line per measured case, then the kernels' summary line,
and as its last line ``{"ok": true, "device": {...}}``.  Exits non-zero,
with no result line, without a card.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, and flop/s for
# bf16 on the tensor cores and fp32 outside them (the kernels' exact fp32)
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {"torch.bfloat16": 989e12, "torch.float32": 67e12}
TOL = {"torch.float32": dict(atol=1e-5, rtol=1e-5),
       "torch.bfloat16": dict(atol=1.6e-2, rtol=1e-2)}
# full-model logits, bf16, kernel vs plain attention: the two attentions
# round the same fp32 values to bf16 and may differ by one ulp per
# element; through 30 layers that moves the logits (spread ~0.5 at this
# init) by at most this much
LOGIT_ATOL = 0.1
# deepseek-moe-16b: a one-ulp bf16 difference in an attention output can
# tip a token's top-6 routing, a discrete change the later layers carry
# on, so no fixed bf16 bound separates a wiring fault from rounding.  The
# kernels are held in fp32 compute (same bf16 weights) to the plain
# versions within DS_FP32_LOGIT_ATOL: ~1e-5 for the same fp32 arithmetic
# in another order through 28 layers, with room for a routing tie tipped
# at an earlier token, which reaches the last token only through
# attention.  In bf16 the kernels' logits must be as accurate as the
# plain versions': within DS_BF16_FLOOR_FACTOR times the plain bf16
# model's own distance from the fp32 plain model, measured in the same
# run (each bf16 model's distance is set by the routing its rounding
# tips, so two equally accurate ones differ by up to twice it)
DS_FP32_LOGIT_ATOL = 1e-2
DS_BF16_FLOOR_FACTOR = 2.0


def log(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(torch, fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean span of one eager call of ``fn`` on the device's timeline over
    ``iters`` back-to-back calls: the device time, or the host's time to
    issue the call where that is longer."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(torch, fn, reps: int = 20, replays: int = 10) -> float:
    """Device time of one call of ``fn``: ``reps`` calls captured in a
    CUDA graph and replayed, so no host time is in the span."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):                  # warm-up outside the capture
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * replays)


def bound(flops: float, nbytes: float, dtype) -> tuple:
    t_ops = flops / PEAK_FLOPS[str(dtype)]
    t_mem = nbytes / HBM_BYTES_S
    return max(t_ops, t_mem) * 1e3, "operations" if t_ops > t_mem else "bytes"


def check_close(torch, name, out, ref, tol) -> float:
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs()
    lim = tol["atol"] + tol["rtol"] * ref.float().abs()
    if not bool(torch.all(err <= lim)) or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version, max abs err {err.max().item()}")
    return err.max().item()


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def flash_cases(torch):
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention.ref import attention_ref
    import torch.nn.functional as F

    dev = torch.device("cuda")
    rows = []
    # smollm-135m's heads (d 64, group 3), then deepseek-moe-16b's (d 128,
    # MHA), whose 160.5 KB of shared memory need the opt-in above 48 KB
    cases = [((1, 9, 3, 64), sq_w) for sq_w in
             ((1, 0), (127, 0), (129, 0), (300, 0), (300, 64))]
    cases += [((1, 16, 16, 128), sq_w) for sq_w in
              ((1, 0), (129, 0), (300, 0))]
    for dtype in (torch.float32, torch.bfloat16):
        for (b, hq, hkv, d), (sq, window) in cases:
            g = torch.Generator(device=dev).manual_seed(sq + window + d)
            # the model's (b, s, h, d) tensors, viewed as (b, h, s, d)
            q, k, v = (torch.randn((b, sq, h, d), generator=g, device=dev)
                       .to(dtype).transpose(1, 2)
                       for h in (hq, hkv, hkv))
            out = fa.flash_attention(q, k, v, window=window)
            ref = attention_ref(q, k, v, window=window)
            err = check_close(torch, f"flash d={d} hq={hq} hkv={hkv} sq={sq} "
                              f"w={window} {dtype}", out, ref,
                              TOL[str(dtype)])
            qpos = torch.arange(sq, device=dev)[:, None]
            kpos = torch.arange(sq, device=dev)[None, :]
            mask = kpos <= qpos
            if window:
                mask &= kpos > qpos - window
            pairs = int(mask.sum())
            es = q.element_size()
            nbytes = es * d * (2 * b * hq * sq + 2 * b * hkv * sq)
            flops = 4.0 * d * b * hq * pairs
            bound_ms, bound_by = bound(flops, nbytes, dtype)
            sdpa_kw = ({"attn_mask": mask} if window
                       else {"is_causal": True})
            rows.append({
                "kernel": "flash_attention", "dtype": str(dtype), "b": b,
                "hq": hq, "hkv": hkv, "d": d, "sq": sq, "window": window,
                "max_abs_err": err, "tol": TOL[str(dtype)],
                "kernel_ms": graph_ms(torch, lambda: fa.flash_attention(
                    q, k, v, window=window)),
                "kernel_call_ms": cuda_ms(torch, lambda: fa.flash_attention(
                    q, k, v, window=window)),
                "plain_ms": graph_ms(torch, lambda: attention_ref(
                    q, k, v, window=window)),
                "library_ms": graph_ms(
                    torch, lambda: F.scaled_dot_product_attention(
                        q, k, v, enable_gqa=True, **sdpa_kw)),
                "bound_ms": bound_ms, "bound_by": bound_by})
            log(rows[-1])
    return rows


def paged_cases(torch):
    from repro_torch.kernels.paged_attention import paged_attention as pa
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref

    dev = torch.device("cuda")
    bt, nb = 128, 3
    lengths = [0, 1, 100, 127, 128, 129, 250, 300]
    rows = []
    # smollm-135m's heads, then deepseek-moe-16b's (d 128, group 1)
    cases = [((8, 9, 3, 64), w) for w in (0, 100)] + [((8, 16, 16, 128), 0)]
    for dtype in (torch.float32, torch.bfloat16):
        for (b, hq, hkv, d), window in cases:
            n_pages = b * nb + 1
            g = torch.Generator(device=dev).manual_seed(7 + window + d)
            q = torch.randn((b, hq, d), generator=g, device=dev).to(dtype)
            kp, vp = (torch.randn((hkv, n_pages, bt, d), generator=g,
                                  device=dev).to(dtype) for _ in range(2))
            tables = torch.randperm(b * nb, generator=g, device=dev) \
                .reshape(b, nb).to(torch.int32)
            for r, n in enumerate(lengths):
                tables[r, -(-n // bt):] = n_pages - 1      # null-page tail
            lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
            args = (q, kp, vp, tables, lens)
            out = pa.paged_attention(*args, window=window)
            ref = paged_attention_ref(*args, window=window)
            err = check_close(torch, f"paged d={d} hq={hq} hkv={hkv} "
                              f"w={window} {dtype}", out, ref,
                              TOL[str(dtype)])
            if not bool(torch.all(out[0] == 0)):
                raise AssertionError("paged: a length-0 row is not zeros")
            keys = sum(min(n, window) if window else n for n in lengths)
            es = q.element_size()
            nbytes = (es * (2 * b * hq * d + 2 * hkv * keys * d)
                      + 4 * (tables.numel() + lens.numel()))
            flops = 4.0 * d * (hq // hkv) * hkv * keys
            bound_ms, bound_by = bound(flops, nbytes, dtype)
            rows.append({
                "kernel": "paged_attention", "dtype": str(dtype), "b": b,
                "hq": hq, "hkv": hkv, "d": d, "block_tokens": bt,
                "lengths": lengths, "window": window, "max_abs_err": err,
                "tol": TOL[str(dtype)],
                "kernel_ms": graph_ms(torch, lambda: pa.paged_attention(
                    *args, window=window)),
                "kernel_call_ms": cuda_ms(torch, lambda: pa.paged_attention(
                    *args, window=window)),
                "plain_ms": graph_ms(torch, lambda: paged_attention_ref(
                    *args, window=window)),
                "library_ms": None,    # no one PyTorch call takes a block table
                "bound_ms": bound_ms, "bound_by": bound_by})
            log(rows[-1])
    return rows


def gmm_cases(torch):
    """The experts' three products of deepseek-moe-16b: decode (8 rows x
    top-6 at the raised capacity: C = 48), prefill of a 200-token prompt
    (C = 24), and a ragged shape no tile divides."""
    from repro_torch.kernels.moe_gmm import moe_gmm as mg
    from repro_torch.kernels.moe_gmm.ref import moe_gmm_ref

    dev = torch.device("cuda")
    shapes = [("decode_wi", 64, 48, 2048, 1408),
              ("decode_wo", 64, 48, 1408, 2048),
              ("prefill_wi", 64, 24, 2048, 1408),
              ("ragged", 4, 24, 64, 44)]
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        for what, e, c, k, f in shapes:
            g = torch.Generator(device=dev).manual_seed(e + c + k + f)
            x = torch.randn((e, c, k), generator=g, device=dev).to(dtype)
            w = (torch.randn((e, k, f), generator=g, device=dev)
                 * k ** -0.5).to(dtype)
            out = mg.moe_gmm(x, w)
            err = check_close(torch, f"moe_gmm {what} {dtype}", out,
                              moe_gmm_ref(x, w), TOL[str(dtype)])
            es = x.element_size()
            nbytes = es * (e * c * k + e * k * f + e * c * f)
            flops = 2.0 * e * c * k * f
            bound_ms, bound_by = bound(flops, nbytes, dtype)
            rows.append({
                "kernel": "moe_gmm", "dtype": str(dtype), "case": what,
                "e": e, "c": c, "k": k, "f": f, "max_abs_err": err,
                "tol": TOL[str(dtype)],
                "kernel_ms": graph_ms(torch, lambda: mg.moe_gmm(x, w)),
                "kernel_call_ms": cuda_ms(torch, lambda: mg.moe_gmm(x, w)),
                "plain_ms": graph_ms(torch, lambda: moe_gmm_ref(x, w)),
                "library_ms": graph_ms(torch, lambda: torch.bmm(x, w)),
                "bound_ms": bound_ms, "bound_by": bound_by})
            log(rows[-1])
            del x, w, out
    return rows


# ---------------------------------------------------------------------------
# phases 3 and 4: the serving paths at full width
# ---------------------------------------------------------------------------

def _kernel_modules():
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.moe_gmm import moe_gmm as mg
    from repro_torch.kernels.paged_attention import paged_attention as pa

    return {"flash_attention": fa, "paged_attention": pa, "moe_gmm": mg}


def reset_counts():
    for mod in _kernel_modules().values():
        mod.LAUNCHES = 0


def read_counts():
    return {name: mod.LAUNCHES for name, mod in _kernel_modules().items()}


def per_call_launches(cfg):
    """Launches of each kernel per prefill and per decode step."""
    n_moe = cfg.num_layers - cfg.first_k_dense if cfg.num_experts else 0
    return ({"flash_attention": cfg.num_layers, "paged_attention": 0,
             "moe_gmm": 3 * n_moe},
            {"flash_attention": 0, "paged_attention": cfg.num_layers,
             "moe_gmm": 3 * n_moe})


def check_launches(cfg, counts, prefills, decode_steps, what):
    per_pre, per_dec = per_call_launches(cfg)
    want = {k: per_pre[k] * prefills + per_dec[k] * decode_steps
            for k in per_pre}
    if counts != want or not prefills or not decode_steps:
        raise AssertionError(
            f"{what}: kernel launches {counts}, expected {want} for "
            f"{cfg.name} ({per_pre} per prefill, {per_dec} per decode "
            f"step; {prefills} prefills, {decode_steps} decode steps)")


def serve_cli(cfg):
    from repro_torch.launch import serve

    argv = ["--requests", "16", "--batch", "8", "--prompt-len", "200",
            "--max-new", "64"]
    reset_counts()
    t0 = time.perf_counter()
    out = serve.main(argv)
    wall = time.perf_counter() - t0
    counts = read_counts()
    ex = out["executor"]
    check_launches(cfg, counts, ex["prefills"], ex["decode_steps"], "CLI")
    if out["tokens"] != 16 * 64 or out["requests"] != 16:
        raise AssertionError(f"CLI generated {out['tokens']} tokens for "
                             f"{out['requests']} requests, expected 1024/16")
    if ex["decode_shapes"] != 1:
        raise AssertionError(f"decode input shapes changed: {ex}")
    log({"phase": "serve_cli", "argv": argv, "wall_s": wall,
         "launches": counts, "executor": ex, "tokens": out["tokens"],
         "mean_ttft_s": out["ttft_s"]["mean"],
         "slo_goodput": out["slo_goodput"], "RG": out["goodput"]["RG"]})
    return counts


def serve_engine(torch, cfg, n_req: int, max_new_hi: int, phase: str):
    """The continuous engine over ``make_executor`` (params drawn on the
    card from seed 0): ``n_req`` requests with prompts of 40-300 tokens
    and 16-``max_new_hi`` new tokens through 8 slots, so rows admit and
    detach while others decode."""
    import numpy as np

    from repro_torch.serve.batched_executor import make_executor
    from repro_torch.serve.engine import (NO_SLO, ContinuousServeEngine,
                                          ServeRequest)

    rng = np.random.default_rng(0)
    n_slots, max_len = 8, 300 + 64
    reqs = []
    for i in range(n_req):
        plen = int(rng.integers(40, 301))
        reqs.append(ServeRequest(
            rid=i, prompt_len=plen,
            max_new=int(rng.integers(16, max_new_hi + 1)),
            prompt=rng.integers(0, cfg.vocab_size, plen).astype(np.int32)))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ex, kv = make_executor(cfg, max_len, n_slots)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    decode = {"s": 0.0, "tokens": 0}
    # (event, decode steps so far, rows live) for each admission / detach
    events = []
    orig_decode, orig_prefill, orig_release = (ex.decode, ex.prefill,
                                               ex.release)

    def timed_decode(rs):
        toks, cost = orig_decode(rs)
        decode["s"] += cost
        decode["tokens"] += len(toks)
        return toks, cost

    def prefill(rs):
        events.append(("admit", ex.decode_steps, len(ex.rows)))
        return orig_prefill(rs)

    def release(r):
        events.append(("detach", ex.decode_steps, len(ex.rows)))
        return orig_release(r)

    ex.decode, ex.prefill, ex.release = timed_decode, prefill, release
    reset_counts()
    t0 = time.perf_counter()
    rep = ContinuousServeEngine(n_slots, ex, slo=NO_SLO, kv_cache=kv).run(reqs)
    wall = time.perf_counter() - t0
    counts = read_counts()
    check_launches(cfg, counts, ex.prefills, ex.decode_steps, phase)
    want = sum(r.max_new for r in reqs)
    if rep.tokens != want or ex.decode_shape_count() != 1:
        raise AssertionError(f"{phase}: {rep.tokens} tokens (want {want}), "
                             f"{ex.decode_shape_count()} decode shapes")
    crossed = sum(1 for r in reqs
                  if (r.prompt_len - 1) // 128
                  != (r.prompt_len + r.max_new - 2) // 128)
    if not crossed:
        raise AssertionError(f"{phase}: no request's decode crossed a page")
    last = ex.decode_steps
    admitted_mid = sum(1 for ev, step, live in events
                       if ev == "admit" and step > 0 and live > 0)
    detached_mid = sum(1 for ev, step, live in events
                       if ev == "detach" and step < last and live > 1)
    if not admitted_mid or not detached_mid:
        raise AssertionError(f"{phase}: {admitted_mid} admissions and "
                             f"{detached_mid} detaches mid-flight")
    log({"phase": phase, "arch": cfg.name, "requests": n_req,
         "n_slots": n_slots, "prompt_lens": [r.prompt_len for r in reqs],
         "max_new": [r.max_new for r in reqs], "crossed_page": crossed,
         "admitted_mid_flight": admitted_mid,
         "detached_mid_flight": detached_mid, "init_s": init_s,
         "wall_s": wall, "launches": counts, "prefills": ex.prefills,
         "decode_steps": ex.decode_steps, "tokens": rep.tokens,
         "decode_tokens_per_s": decode["tokens"] / decode["s"],
         "mean_ttft_s": rep.ttft_s["mean"], "slo_goodput": rep.slo_goodput,
         "RG": rep.goodput["RG"], "preemptions": rep.preemptions,
         "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    return counts, ex.params


# the logits phase's page pool: 3 pages of 128 tokens per prompt row
PAGE_TOKENS, PAGES_PER_ROW = 128, 3


def _full_model_logits(torch, cfg, params, impl, prompts, tok=None):
    """Prefill logits of ``prompts`` (one per row, scattered into pages)
    and the first batched decode step's logits over those pages, with
    every kernel (impl "kernel") or every plain version ("ref").  The
    decode step feeds ``tok`` (default: the prefill's argmax) and runs at
    the executor's decode config.  Returns (prefill, decode, decode
    inputs)."""
    from repro_torch.models import transformer
    from repro_torch.serve.batched_executor import decode_config

    dev = torch.device("cuda")
    bt, nb = PAGE_TOKENS, PAGES_PER_ROW
    tables = torch.arange(len(prompts) * nb, device=dev, dtype=torch.int32) \
        .reshape(len(prompts), nb)
    kp = torch.zeros(transformer.paged_kv_shape(cfg, len(prompts) * nb, bt),
                     dtype=cfg.compute_dtype, device=dev)
    vp = torch.zeros_like(kp)
    pre = []
    for row, p in enumerate(prompts):
        logits, cache = transformer.prefill(
            params, {"tokens": p}, cfg, max_len=bt * nb, attn_impl=impl,
            gmm_impl=impl)
        pos = torch.arange(p.shape[1], device=dev)
        transformer.scatter_prefill_pages(
            cache, cfg, kp, vp, tables[row].long()[pos // bt], pos % bt)
        pre.append(logits[0])
    pre = torch.stack(pre)
    tok = pre.argmax(-1) if tok is None else tok
    lengths = torch.tensor([p.shape[1] + 1 for p in prompts],
                           dtype=torch.int32, device=dev)
    cfg_dec = decode_config(cfg)
    dec, _, _ = transformer.paged_decode_step(
        params, tok, lengths, kp, vp, tables, cfg_dec, attn_impl=impl,
        gmm_impl=impl)
    return pre, dec, (tok, lengths, kp, vp, tables, cfg_dec)


def _compare_logits(torch, a, b, tol):
    """The figures of logits ``a`` against ``b``; "ok" when ``a`` is
    finite, within ``tol`` of ``b`` and of the same argmax on every row
    whose top-2 gap in ``b`` exceeds it."""
    finite = bool(torch.isfinite(a).all()) and bool(torch.isfinite(b).all())
    err = (a - b).abs().max().item()
    top2 = b.topk(2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > tol
    same = a.argmax(-1) == b.argmax(-1)
    ok = finite and err <= tol and bool(same[clear].all())
    return {"ok": ok, "max_abs_err": err, "tol": tol,
                "rows_checked_argmax": int(clear.sum()),
                "argmax_agree": int(same.sum()),
                "logit_spread": b.std().item()}


def logits_kernel_vs_plain(torch, cfg, params, tol):
    """The full model at full width with every kernel against every plain
    version, same weights and inputs: prefill of 8 prompts and the first
    batched decode step over their pages, held to ``tol``.

    ``tol=None`` (MoE) runs the comparison in fp32 compute too, held to
    ``DS_FP32_LOGIT_ATOL``, and holds the kernels' bf16 logits to the fp32
    plain ones within ``DS_BF16_FLOOR_FACTOR`` times the plain bf16
    logits' distance from them.  Every comparison is logged, then a
    failed one raises."""
    from repro_torch.models import transformer

    dev = torch.device("cuda")
    lens = [40, 77, 127, 128, 129, 200, 255, 300]
    g = torch.Generator(device=dev).manual_seed(11)
    prompts = [torch.randint(0, cfg.vocab_size, (1, n), generator=g,
                             device=dev) for n in lens]
    res = {}
    with torch.inference_mode():
        kern = _full_model_logits(torch, cfg, params, "kernel", prompts)
        tok = kern[2][0]
        plain = _full_model_logits(torch, cfg, params, "ref", prompts, tok)
        if tol is not None:
            for i, name in enumerate(("prefill", "decode")):
                res[name] = _compare_logits(torch, kern[i], plain[i], tol)
        else:
            cfg32 = dataclasses.replace(cfg, compute_dtype=torch.float32)
            k32 = _full_model_logits(torch, cfg32, params, "kernel", prompts,
                                     tok)
            p32 = _full_model_logits(torch, cfg32, params, "ref", prompts,
                                     tok)
            for i, name in enumerate(("prefill", "decode")):
                res[f"{name}_fp32"] = _compare_logits(
                    torch, k32[i], p32[i], DS_FP32_LOGIT_ATOL)
                floor = (plain[i] - p32[i]).abs().max().item()
                res[name] = _compare_logits(
                    torch, kern[i], p32[i], DS_BF16_FLOOR_FACTOR * floor)
                res[name].update(
                    plain_bf16_vs_fp32=floor,
                    kernel_vs_plain_bf16=(kern[i] - plain[i]).abs().max()
                    .item())
            del k32, p32
        # where a full-model call's time goes: its span on the device
        # timeline when issued eagerly (the serving path) against its
        # device time alone (CUDA-graph replay)
        tok, lengths, kp, vp, tables, cfg_dec = kern[2]
        step = lambda: transformer.paged_decode_step(          # noqa: E731
            params, tok, lengths, kp, vp, tables, cfg_dec)
        pre200 = lambda: transformer.prefill(                  # noqa: E731
            params, {"tokens": prompts[5]}, cfg,
            max_len=PAGE_TOKENS * PAGES_PER_ROW)
        timing = {"decode_step_w8": {"eager_ms": cuda_ms(torch, step, 20),
                                     "device_ms": graph_ms(torch, step, 5)},
                  "prefill_s200": {"eager_ms": cuda_ms(torch, pre200, 20),
                                   "device_ms": graph_ms(torch, pre200, 5)}}
    log({"phase": "logits_kernel_vs_plain", "arch": cfg.name,
         "prompt_lens": lens, **res})
    log({"phase": "full_model_timing", "arch": cfg.name, "prompt_lens": lens,
         **timing})
    failed = [name for name, r in res.items() if not r["ok"]]
    if failed:
        raise AssertionError(f"{cfg.name}: kernel logits off the plain "
                             f"versions' in {failed}: {res}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one",
              file=sys.stderr)
        return 1
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    log({"torch": torch.__version__, "cuda": torch.version.cuda,
         "device": torch.cuda.get_device_name(0),
         "count": torch.cuda.device_count()})
    t0 = time.perf_counter()
    reports = _build.build()
    log({"phase": "build", "seconds": time.perf_counter() - t0,
         "ptxas": {k: [ln.strip() for ln in v.splitlines()
                       if "Used" in ln or "spill" in ln]
                   for k, v in reports.items()}})
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    flash = flash_cases(torch)
    paged = paged_cases(torch)
    gmm = gmm_cases(torch)

    cfg = get_config("smollm-135m")
    if cfg.compute_dtype != torch.bfloat16 or cfg.num_layers != 30:
        raise AssertionError(f"smollm-135m is not at full width: {cfg}")
    c_cli = serve_cli(cfg)
    c_eng, params = serve_engine(torch, cfg, 24, 64, "serve_engine")
    logits_kernel_vs_plain(torch, cfg, params, LOGIT_ATOL)
    del params
    gc.collect()
    torch.cuda.empty_cache()

    # the reference's serve_bf16 variant: 32.8 GB of bf16 params
    ds = dataclasses.replace(get_config("deepseek-moe-16b"),
                             param_dtype=torch.bfloat16)
    if (ds.num_layers, ds.d_model, ds.num_experts, ds.experts_per_token,
            ds.num_shared_experts, ds.first_k_dense, ds.vocab_size) != (
            28, 2048, 64, 6, 2, 1, 102400):
        raise AssertionError(f"deepseek-moe-16b is not at full width: {ds}")
    c_ds, params = serve_engine(torch, ds, 12, 48, "serve_engine_deepseek")
    logits_kernel_vs_plain(torch, ds, params, None)
    del params
    gc.collect()
    torch.cuda.empty_cache()

    # the summary: the main paths' bf16 shapes (flash at the longest
    # smollm prompt, paged at smollm's mixed batch, the grouped matmul at
    # deepseek's decode) with the launches of every serving run
    def summary(rows, name, source, replaces, pick):
        r = [x for x in rows if pick(x)][0]
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces,
                "launches": c_cli[name] + c_eng[name] + c_ds[name],
                "max_abs_err": max(x["max_abs_err"] for x in rows
                                   if x["dtype"] == r["dtype"]),
                "ms": r["kernel_ms"], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                "library_ms": r["library_ms"]}

    bf16 = "torch.bfloat16"
    log({"kernels": [
        summary(paged, "paged_attention",
                "src/repro_torch/kernels/csrc/paged_attention.cu",
                "src/repro/kernels/paged_attention/paged_attention.py:110",
                lambda x: x["dtype"] == bf16 and x["window"] == 0
                and x["d"] == 64),
        summary(flash, "flash_attention",
                "src/repro_torch/kernels/csrc/flash_attention.cu",
                "src/repro/kernels/flash_attention/flash_attention.py:70",
                lambda x: x["dtype"] == bf16 and x["sq"] == 300
                and x["window"] == 0 and x["d"] == 64),
        summary(gmm, "moe_gmm", "src/repro_torch/kernels/csrc/moe_gmm.cu",
                "src/repro/kernels/moe_gmm/moe_gmm.py:39",
                lambda x: x["dtype"] == bf16 and x["case"] == "decode_wi"),
    ]})
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
