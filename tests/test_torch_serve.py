"""The port's serve path against the reference's.

* Real model: the port's engine over ``TorchBatchedExecutor`` (CPU, the
  reference's weights through ``params_from_numpy``) against the
  reference's ``ContinuousServeEngine`` over ``JaxBatchedExecutor``
  (attn_impl="ref"), both under ``TickClock(dt=1.0)``, on the
  ``batched_tiny`` request stream of BENCH_serve.json, for smollm-135m
  and deepseek-moe-16b (MoE decode at the raised capacity): every
  request's tokens are identical and ``ServeReport.as_dict()`` is equal
  field by field.
* Accounting alone: the port's copied engine / allocator / ledger with
  ``SimulatedExecutor`` give the reference's report exactly, including
  SLO breaches and preemption.
* The CLI runs with ``--smoke --device cpu`` and, under a TickClock,
  reports what the reference's CLI reports, for both archs.
"""
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_smoke as jsmoke  # noqa: E402
from repro.launch import serve as jserve_cli  # noqa: E402
from repro.serve import engine as jeng  # noqa: E402
from repro.serve.batched_executor import JaxBatchedExecutor  # noqa: E402
from repro.serve.kv_cache import PagedKVCache as JPagedKVCache  # noqa: E402
from repro_torch.configs import get_smoke as tsmoke  # noqa: E402
from repro_torch.launch import serve as tserve_cli  # noqa: E402
from repro_torch.models.init import params_from_numpy  # noqa: E402
from repro_torch.serve import engine as teng  # noqa: E402
from repro_torch.serve.batched_executor import (  # noqa: E402
    TorchBatchedExecutor, make_executor)
from repro_torch.serve.kv_cache import \
    PagedKVCache as TPagedKVCache  # noqa: E402

BENCH = json.loads((Path(__file__).parents[1] / "BENCH_serve.json")
                   .read_text())["batched_tiny"]["config"]


def _stream(eng_mod, cfg, vocab):
    """The batched_tiny stream (benchmarks/serve_scale.py's generator)."""
    rng = np.random.default_rng(cfg["seed"])
    nlo, nhi = cfg["max_new"]
    reqs = []
    for i in range(cfg["requests"]):
        plen = int(rng.choice(cfg["prompt_lens"]))
        reqs.append(eng_mod.ServeRequest(
            rid=i, prompt_len=plen, max_new=int(rng.integers(nlo, nhi + 1)),
            t_submit=0.0,
            prompt=rng.integers(0, vocab, plen).astype(np.int32)))
    return reqs


def _engine_parity(arch):
    """Both engines over the same stream and weights; returns the port's
    executor after asserting identical tokens and equal reports."""
    jcfg, tcfg = jsmoke(arch), tsmoke(arch)
    n_slots, max_len = BENCH["n_slots"], BENCH["max_len"]
    # a tight SLO so both engines book on-time and late decode
    slo_args = dict(ttft=6.0, tpot=2.0)

    jex = JaxBatchedExecutor(jcfg, max_len, n_slots,
                             clock=jserve_cli.TickClock(1.0),
                             attn_impl=BENCH["attn_impl"])
    jreqs = _stream(jeng, BENCH, jcfg.vocab_size)
    jrep = jeng.ContinuousServeEngine(
        n_slots, jex, slo=jeng.ServeSLO(**slo_args),
        kv_cache=jex.kv).run(jreqs)

    tex = TorchBatchedExecutor(
        tcfg, max_len, n_slots, clock=tserve_cli.TickClock(1.0),
        device="cpu",
        params=params_from_numpy(jax.tree.map(np.asarray, jex.params),
                                 "cpu"))
    treqs = _stream(teng, BENCH, tcfg.vocab_size)
    trep = teng.ContinuousServeEngine(
        n_slots, tex, slo=teng.ServeSLO(**slo_args),
        kv_cache=tex.kv).run(treqs)

    assert len(treqs) == BENCH["requests"] == 24
    for jr, tr in zip(jreqs, treqs):
        assert tr.out_tokens == jr.out_tokens, f"request {tr.rid}"
    assert trep.as_dict() == jrep.as_dict()
    assert 0 < trep.tokens_within_slo < trep.tokens     # both phases seen
    assert tex.decode_shape_count() == 1
    return tex


def test_batched_tiny_tokens_and_report_match_reference():
    assert BENCH["arch"] == "smollm-135m" and BENCH["attn_impl"] == "ref"
    tex = _engine_parity(BENCH["arch"])
    assert tex.prefills == 24 and tex.decode_steps == 57


def test_deepseek_engine_tokens_and_report_match_reference():
    tex = _engine_parity("deepseek-moe-16b")
    assert tex.prefills == 24 and tex.decode_steps == 57


def _sim_stream(eng_mod):
    rng = np.random.default_rng(3)
    return [eng_mod.ServeRequest(rid=i, prompt_len=int(rng.integers(20, 200)),
                                 max_new=int(rng.integers(1, 90)),
                                 t_submit=float(i // 3) * 0.02)
            for i in range(40)]


def test_simulated_engine_report_matches_reference():
    """Arrivals over time, an SLO that some tokens miss, and an allocator
    too small for the load (recompute preemptions) — the copied engine,
    allocator and ledger book all of it as the reference does."""
    slo = dict(ttft=0.05, tpot=0.012)
    jrep = jeng.ContinuousServeEngine(
        6, jeng.SimulatedExecutor(), slo=jeng.ServeSLO(**slo),
        kv_cache=JPagedKVCache(6, 64)).run(_sim_stream(jeng))
    trep = teng.ContinuousServeEngine(
        6, teng.SimulatedExecutor(), slo=teng.ServeSLO(**slo),
        kv_cache=TPagedKVCache(6, 64)).run(_sim_stream(teng))
    assert trep.preemptions > 0
    assert 0 < trep.tokens_within_slo < trep.tokens
    assert trep.as_dict() == jrep.as_dict()


@pytest.mark.parametrize("arch", ["smollm-135m", "deepseek-moe-16b"])
def test_cli_smoke_on_cpu_matches_reference_cli(capsys, arch):
    """Same flags, TickClock time: the report is a function of the request
    stream and the clock, so the two CLIs agree although their random
    weights differ."""
    argv = ["--arch", arch, "--smoke", "--requests", "9", "--batch", "4",
            "--prompt-len", "16", "--max-new", "6", "--tick-dt", "1",
            "--slo-ttft", "4"]
    out = tserve_cli.main(argv + ["--device", "cpu"])
    capsys.readouterr()
    jserve_cli.main(argv)
    ref = json.loads(capsys.readouterr().out)
    assert out.pop("executor") == {"prefills": 9, "decode_steps": 15,
                                   "decode_shapes": 1}
    assert out == ref
    assert out["tokens"] == 9 * 6


def test_make_executor_picks_as_the_reference():
    """make_executor follows the reference's rule and substitutes nothing:
    paged-decode families get the batched executor, the others (and
    windows narrower than max_len) the per-slot one; the batched executor
    itself refuses a window."""
    import dataclasses

    from repro_torch.serve.slot_executor import TorchSlotExecutor

    cfg = dataclasses.replace(tsmoke("smollm-135m"), family="ssm")
    ex, kv = make_executor(cfg, 32, 2, device="cpu")
    assert isinstance(ex, TorchSlotExecutor)
    windowed = dataclasses.replace(tsmoke("smollm-135m"), attention_window=8)
    with pytest.raises(ValueError, match="paged"):
        TorchBatchedExecutor(windowed, 32, 2, device="cpu")
    # mixtral's SMOKE window (16) is narrower than the 32-token max_len
    ex, kv = make_executor(tsmoke("mixtral-8x7b"), 32, 2, device="cpu")
    assert isinstance(ex, TorchSlotExecutor)
    assert (kv.block_tokens, kv.n_blocks) == (32, 2)
    ex, kv = make_executor(tsmoke("smollm-135m"), 32, 2, device="cpu")
    assert isinstance(ex, TorchBatchedExecutor) and kv is ex.kv
    # enc-dec and vlm take the per-slot executor, as the reference's
    for arch in ("whisper-medium", "llava-next-mistral-7b"):
        ex, kv = make_executor(tsmoke(arch), 32, 2, device="cpu")
        assert isinstance(ex, TorchSlotExecutor)
    unknown = dataclasses.replace(tsmoke("smollm-135m"), family="rnn")
    with pytest.raises(ValueError, match="unknown model family"):
        make_executor(unknown, 32, 2, device="cpu")


def test_rows_recycle_and_release():
    cfg = tsmoke("smollm-135m")
    ex = TorchBatchedExecutor(cfg, 32, 2, device="cpu")
    reqs = [teng.ServeRequest(rid=i, prompt_len=5, max_new=3,
                              prompt=np.arange(5, dtype=np.int32) + i)
            for i in range(2)]
    for r in reqs:
        ex.kv.allocate(r.rid, r.prompt_len)
    ex.prefill(reqs)
    assert len(ex.rows) == 2 and not ex._free_rows
    ex.kv.free(reqs[0].rid)
    ex.release(reqs[0])
    row = 1 - ex.rows[reqs[1].rid]
    assert ex._len[row] == 0 and np.all(ex._tables[row] == ex.null_page)
