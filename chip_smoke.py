#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on the GPU.

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` (on PATH or in /usr/local/cuda/bin) and the
checkout's ``src/``; imports nothing of JAX or of the JAX package.  Phases,
each of which raises on failure (nothing is caught):

1. the card's name and power limit, the torch/CUDA versions, and the
   build of both kernels from ``src/repro_torch/kernels/csrc`` (nvcc,
   sm_90a, both sources at once);
2. each kernel against its plain PyTorch version at the serving path's
   shapes, fp32 (tight) and bf16 (one bf16 ulp), with its time, the plain
   version's time, the time of the one PyTorch call that computes the
   same function where there is one, and its bound on the H100;
3. the serving path of smollm-135m at full width (30 layers, vocab 49152,
   bf16, random weights from a seed): (a) the CLI entry point, (b) the
   engine over the batched executor with mixed prompt lengths, and (c)
   kernel-vs-plain logits of the full model's prefill and first decode
   step.  The kernels' launch counters are zeroed before (a) and (b) and
   must read 30 x prefills (flash) and 30 x decode steps (paged) after.

Prints one JSON line per measured case, then the kernels' summary line,
and as its last line ``{"ok": true, "device": {...}}``.  Exits non-zero,
with no result line, without a card.
"""
from __future__ import annotations

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
    b, hq, hkv, d = 1, 9, 3, 64
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        for sq, window in ((1, 0), (127, 0), (129, 0), (300, 0), (300, 64)):
            g = torch.Generator(device=dev).manual_seed(sq + window)
            # the model's (b, s, h, d) tensors, viewed as (b, h, s, d)
            q, k, v = (torch.randn((b, sq, h, d), generator=g, device=dev)
                       .to(dtype).transpose(1, 2)
                       for h in (hq, hkv, hkv))
            out = fa.flash_attention(q, k, v, window=window)
            ref = attention_ref(q, k, v, window=window)
            err = check_close(torch, f"flash sq={sq} w={window} {dtype}",
                              out, ref, TOL[str(dtype)])
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
    b, hq, hkv, d, bt, nb = 8, 9, 3, 64, 128, 3
    lengths = [0, 1, 100, 127, 128, 129, 250, 300]
    n_pages = b * nb + 1
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        for window in (0, 100):
            g = torch.Generator(device=dev).manual_seed(7 + window)
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
            err = check_close(torch, f"paged w={window} {dtype}", out, ref,
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


# ---------------------------------------------------------------------------
# phase 3: the serving path at full width
# ---------------------------------------------------------------------------

def reset_counts():
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.paged_attention import paged_attention as pa

    fa.LAUNCHES = 0
    pa.LAUNCHES = 0


def read_counts():
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.paged_attention import paged_attention as pa

    return {"flash_attention": fa.LAUNCHES, "paged_attention": pa.LAUNCHES}


def check_launches(cfg, counts, prefills, decode_steps, what):
    want = {"flash_attention": cfg.num_layers * prefills,
            "paged_attention": cfg.num_layers * decode_steps}
    if counts != want or not prefills or not decode_steps:
        raise AssertionError(f"{what}: kernel launches {counts}, expected "
                             f"{want} (30 per prefill / decode step)")


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


def serve_engine(cfg):
    import numpy as np

    from repro_torch.serve.batched_executor import TorchBatchedExecutor
    from repro_torch.serve.engine import (NO_SLO, ContinuousServeEngine,
                                          ServeRequest)

    rng = np.random.default_rng(0)
    n_req, n_slots, max_len = 24, 8, 300 + 64
    reqs = []
    for i in range(n_req):
        plen = int(rng.integers(40, 301))
        reqs.append(ServeRequest(
            rid=i, prompt_len=plen, max_new=int(rng.integers(16, 65)),
            prompt=rng.integers(0, cfg.vocab_size, plen).astype(np.int32)))
    ex = TorchBatchedExecutor(cfg, max_len, n_slots)
    decode = {"s": 0.0, "tokens": 0}
    orig = ex.decode

    def timed_decode(rs):
        toks, cost = orig(rs)
        decode["s"] += cost
        decode["tokens"] += len(toks)
        return toks, cost

    ex.decode = timed_decode
    reset_counts()
    t0 = time.perf_counter()
    rep = ContinuousServeEngine(n_slots, ex, slo=NO_SLO,
                                kv_cache=ex.kv).run(reqs)
    wall = time.perf_counter() - t0
    counts = read_counts()
    check_launches(cfg, counts, ex.prefills, ex.decode_steps, "engine")
    want = sum(r.max_new for r in reqs)
    if rep.tokens != want or ex.decode_shape_count() != 1:
        raise AssertionError(f"engine: {rep.tokens} tokens (want {want}), "
                             f"{ex.decode_shape_count()} decode shapes")
    crossed = sum(1 for r in reqs
                  if (r.prompt_len - 1) // 128
                  != (r.prompt_len + r.max_new - 2) // 128)
    if not crossed:
        raise AssertionError("engine: no request's decode crossed a page")
    log({"phase": "serve_engine", "requests": n_req, "n_slots": n_slots,
         "prompt_lens": [r.prompt_len for r in reqs],
         "max_new": [r.max_new for r in reqs], "crossed_page": crossed,
         "wall_s": wall, "launches": counts, "prefills": ex.prefills,
         "decode_steps": ex.decode_steps, "tokens": rep.tokens,
         "decode_tokens_per_s": decode["tokens"] / decode["s"],
         "mean_ttft_s": rep.ttft_s["mean"], "slo_goodput": rep.slo_goodput,
         "RG": rep.goodput["RG"], "preemptions": rep.preemptions})
    return counts, ex.params


def logits_kernel_vs_plain(torch, cfg, params):
    """Prefill of 8 prompts and the first batched decode step over their
    pages, with the kernels and with the plain attention, same weights
    and inputs: finite logits within LOGIT_ATOL, same argmax on every row
    whose top-2 gap exceeds it."""
    from repro_torch.models import transformer

    dev = torch.device("cuda")
    lens = [40, 77, 127, 128, 129, 200, 255, 300]
    bt, nb = 128, 3
    g = torch.Generator(device=dev).manual_seed(11)
    prompts = [torch.randint(0, cfg.vocab_size, (1, n), generator=g,
                             device=dev) for n in lens]
    tables = torch.arange(len(lens) * nb, device=dev, dtype=torch.int32) \
        .reshape(len(lens), nb)
    shape = transformer.paged_kv_shape(cfg, len(lens) * nb, bt)
    out = {}
    with torch.inference_mode():
        for impl in ("kernel", "ref"):
            kp = torch.zeros(shape, dtype=cfg.compute_dtype, device=dev)
            vp = torch.zeros_like(kp)
            pre = []
            for row, p in enumerate(prompts):
                logits, cache = transformer.prefill(
                    params, {"tokens": p}, cfg, max_len=bt * nb,
                    attn_impl=impl)
                pos = torch.arange(p.shape[1], device=dev)
                transformer.scatter_prefill_pages(
                    cache, cfg, kp, vp, tables[row].long()[pos // bt],
                    pos % bt)
                pre.append(logits[0])
            pre = torch.stack(pre)
            tok = out["kernel"][0].argmax(-1) if impl == "ref" \
                else pre.argmax(-1)
            lengths = torch.tensor(lens, dtype=torch.int32, device=dev) + 1
            dec, _, _ = transformer.paged_decode_step(
                params, tok, lengths, kp, vp, tables, cfg, attn_impl=impl)
            out[impl] = (pre, dec)
        # where a full-model call's time goes: its span on the device
        # timeline when issued eagerly (the serving path) against its
        # device time alone (CUDA-graph replay)
        step = lambda: transformer.paged_decode_step(          # noqa: E731
            params, tok, lengths, kp, vp, tables, cfg)
        pre200 = lambda: transformer.prefill(                  # noqa: E731
            params, {"tokens": prompts[5]}, cfg, max_len=bt * nb)
        timing = {"decode_step_w8": {"eager_ms": cuda_ms(torch, step, 20),
                                     "device_ms": graph_ms(torch, step, 5)},
                  "prefill_s200": {"eager_ms": cuda_ms(torch, pre200, 20),
                                   "device_ms": graph_ms(torch, pre200, 5)}}
    res = {}
    for i, name in enumerate(("prefill", "decode")):
        a, b = out["kernel"][i], out["ref"][i]
        if not (bool(torch.isfinite(a).all()) and bool(torch.isfinite(b).all())):
            raise AssertionError(f"{name}: non-finite logits")
        err = (a - b).abs().max().item()
        top2 = b.topk(2, dim=-1).values
        clear = (top2[:, 0] - top2[:, 1]) > LOGIT_ATOL
        same = a.argmax(-1) == b.argmax(-1)
        if err > LOGIT_ATOL or not bool(same[clear].all()):
            raise AssertionError(f"{name}: kernel logits off the plain "
                                 f"version's by {err} (tol {LOGIT_ATOL})")
        res[name] = {"max_abs_err": err, "tol": LOGIT_ATOL,
                     "rows_checked_argmax": int(clear.sum()),
                     "argmax_agree": int(same.sum()),
                     "logit_spread": b.std().item()}
    log({"phase": "logits_kernel_vs_plain", "prompt_lens": lens, **res})
    log({"phase": "full_model_timing", "prompt_lens": lens, **timing})


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

    cfg = get_config("smollm-135m")
    if cfg.compute_dtype != torch.bfloat16 or cfg.num_layers != 30:
        raise AssertionError(f"smollm-135m is not at full width: {cfg}")
    c_cli = serve_cli(cfg)
    c_eng, params = serve_engine(cfg)
    logits_kernel_vs_plain(torch, cfg, params)

    # the summary: the main path's bf16 shapes (flash at the longest
    # prompt, paged at the mixed batch) with the launches of (a) + (b)
    def summary(rows, name, source, replaces, pick):
        r = [x for x in rows if pick(x)][0]
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces,
                "launches": c_cli[name] + c_eng[name],
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
                lambda x: x["dtype"] == bf16 and x["window"] == 0),
        summary(flash, "flash_attention",
                "src/repro_torch/kernels/csrc/flash_attention.cu",
                "src/repro/kernels/flash_attention/flash_attention.py:70",
                lambda x: x["dtype"] == bf16 and x["sq"] == 300
                and x["window"] == 0),
    ]})
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
