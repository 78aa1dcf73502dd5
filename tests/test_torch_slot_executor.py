"""The port's per-slot serve path against the reference's.

* The engine over ``TorchSlotExecutor`` (CPU, the reference's weights
  through ``params_from_numpy``) against the reference's
  ``ContinuousServeEngine`` over ``JaxSlotExecutor``, both under
  ``TickClock(dt=1.0)`` with an allocator of the reference CLI's sizing,
  for recurrentgemma-2b, rwkv6-3b, mixtral-8x7b (a 16-token window below
  the 20-token max_len, so ``make_executor`` picks the per-slot executor),
  llava-next-mistral-7b (8 patches before the prompt, so the 20-slot
  ring drops patches), whisper-medium (the prompt + 64 ring, zero frames)
  and smollm-135m (asked for explicitly): every request's tokens are
  identical and ``ServeReport.as_dict()`` is equal field by field.
  Seven requests through three slots, so requests admit and detach while
  others decode, and a tight SLO that some tokens miss.
* The CLI with ``--smoke --device cpu`` and ``--executor slot`` (or the
  ``auto`` choice for recurrentgemma-2b, llava-next-mistral-7b and
  whisper-medium) reports what the reference's CLI reports under a
  TickClock.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_smoke as jsmoke  # noqa: E402
from repro.launch import serve as jserve_cli  # noqa: E402
from repro.serve import engine as jeng  # noqa: E402
from repro.serve.jax_executor import JaxSlotExecutor  # noqa: E402
from repro.serve.kv_cache import PagedKVCache as JPagedKVCache  # noqa: E402
from repro_torch.configs import get_smoke as tsmoke  # noqa: E402
from repro_torch.launch import serve as tserve_cli  # noqa: E402
from repro_torch.models.init import params_from_numpy  # noqa: E402
from repro_torch.serve import engine as teng  # noqa: E402
from repro_torch.serve.batched_executor import make_executor  # noqa: E402
from repro_torch.serve.slot_executor import (  # noqa: E402
    TorchSlotExecutor, slot_kv_cache)

N_SLOTS, MAX_LEN = 3, 20
PROMPT_LENS = (7, 12)


def _stream(eng_mod, vocab):
    rng = np.random.default_rng(4)
    reqs = []
    for i in range(7):
        plen = PROMPT_LENS[i % 2]
        reqs.append(eng_mod.ServeRequest(
            rid=i, prompt_len=plen, max_new=int(rng.integers(2, 9)),
            t_submit=0.0,
            prompt=rng.integers(0, vocab, plen).astype(np.int32)))
    return reqs


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "rwkv6-3b",
                                  "mixtral-8x7b", "smollm-135m",
                                  "llava-next-mistral-7b", "whisper-medium"])
def test_engine_tokens_and_report_match_reference(arch):
    jcfg, tcfg = jsmoke(arch), tsmoke(arch)
    slo = dict(ttft=6.0, tpot=2.0)
    # the reference CLI's allocator for the per-slot executor
    bt = min(128, MAX_LEN)
    n_blocks = N_SLOTS * -(-MAX_LEN // bt)

    jex = JaxSlotExecutor(jcfg, MAX_LEN, clock=jserve_cli.TickClock(1.0))
    jreqs = _stream(jeng, jcfg.vocab_size)
    jrep = jeng.ContinuousServeEngine(
        N_SLOTS, jex, slo=jeng.ServeSLO(**slo),
        kv_cache=JPagedKVCache(n_blocks, bt)).run(jreqs)

    params = params_from_numpy(jax.tree.map(np.asarray, jex.params), "cpu")
    if arch == "smollm-135m":       # paged decode applies: ask for slots
        tex = TorchSlotExecutor(tcfg, MAX_LEN,
                                clock=tserve_cli.TickClock(1.0),
                                device="cpu", params=params)
        kv = slot_kv_cache(MAX_LEN, N_SLOTS)
    else:
        tex, kv = make_executor(tcfg, MAX_LEN, N_SLOTS,
                                clock=tserve_cli.TickClock(1.0),
                                device="cpu", params=params)
        assert isinstance(tex, TorchSlotExecutor)
    assert (kv.n_blocks, kv.block_tokens) == (n_blocks, bt)
    treqs = _stream(teng, tcfg.vocab_size)
    trep = teng.ContinuousServeEngine(
        N_SLOTS, tex, slo=teng.ServeSLO(**slo), kv_cache=kv).run(treqs)

    for jr, tr in zip(jreqs, treqs):
        assert tr.out_tokens == jr.out_tokens, f"request {tr.rid}"
    assert trep.as_dict() == jrep.as_dict()
    assert 0 < trep.tokens_within_slo < trep.tokens     # both phases seen
    assert tex.prefills == 7 and tex.decode_steps > 0
    assert not tex._caches and not tex._tok             # all released


@pytest.mark.parametrize("arch,executor", [
    ("recurrentgemma-2b", "auto"), ("smollm-135m", "slot"),
    ("llava-next-mistral-7b", "auto"), ("whisper-medium", "auto")])
def test_cli_slot_executor_matches_reference_cli(capsys, arch, executor):
    argv = ["--arch", arch, "--smoke", "--requests", "5", "--batch", "2",
            "--prompt-len", "12", "--max-new", "5", "--tick-dt", "1",
            "--slo-ttft", "4", "--executor", executor]
    out = tserve_cli.main(argv + ["--device", "cpu"])
    capsys.readouterr()
    jserve_cli.main(argv)
    ref = json.loads(capsys.readouterr().out)
    assert out.pop("executor") == {"prefills": 5, "decode_steps": 12}
    assert out == ref
    assert out["tokens"] == 5 * 5


def test_release_drops_the_request_state():
    cfg = tsmoke("rwkv6-3b")
    ex = TorchSlotExecutor(cfg, 16, device="cpu")
    reqs = [teng.ServeRequest(rid=i, prompt_len=4, max_new=2,
                              prompt=np.arange(4, dtype=np.int32) + i)
            for i in range(2)]
    toks, _ = ex.prefill(reqs)
    assert len(toks) == 2 and set(ex._caches) == {0, 1}
    ex.decode(reqs)
    ex.release(reqs[0])
    assert set(ex._caches) == {1} and set(ex._tok) == {1}
    with pytest.raises(ValueError, match="no prompt"):
        ex.prefill([teng.ServeRequest(rid=5, prompt_len=3, max_new=1)])
