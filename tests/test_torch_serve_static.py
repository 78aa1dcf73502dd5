"""The port's static fixed-group serve loop (``repro_torch.launch.serve``:
``Request``, ``pad_group``, ``Server``, ``run_static_server`` and the
CLI's ``--engine static``) against the reference's.

* ``pad_group`` and the clock discipline, mirroring ``tests/test_serve.py``:
  sentinel clones, exactly three clock reads a batch, intervals tiling
  ``[t0, t2]``.
* ``run_static_server`` on SMOKE under ``TickClock(1.0)``, the reference's
  weights through ``params_from_numpy``: for smollm-135m, granite-3-8b,
  qwen2-72b, recurrentgemma-2b, rwkv6-3b, llava-next-mistral-7b (8
  patches before the 20 tokens: the 25-slot ring drops the oldest
  patches, as the reference's does) and whisper-medium (the reference's
  ring of prompt + 64 inside the port's buffer) at batch 4, six requests
  of 20 tokens (past recurrentgemma's 16-token SMOKE window, so its ring
  wraps; a padded tail group of two) with output lengths 2-5, every
  request's tokens are identical and the report equal key for key.
* The CLI with ``--engine static --device cpu --smoke --tick-dt 1`` prints
  the reference CLI's report (the port's ``static_decode`` key popped).
* ``decode_impl="eager"`` gives "auto"'s tokens; a family the reference
  does not know is refused.
"""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_smoke as jsmoke  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import init as jinit  # noqa: E402
from repro_torch.configs import get_smoke as tsmoke  # noqa: E402
from repro_torch.core.goodput import Phase  # noqa: E402
from repro_torch.core.ledger import GoodputLedger  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch.serve import (Request, Server, TickClock,  # noqa: E402
                                      pad_group, run_static_server)
from repro_torch.models.init import params_from_numpy  # noqa: E402

BATCH, PROMPT, MAX_NEW = 4, 20, 5


def test_pad_group_uses_sentinel_clones():
    reqs = [Request(i, np.zeros(4, np.int32), 8) for i in range(2)]
    padded = pad_group(reqs, 4)
    assert len(padded) == 4
    assert [r.rid for r in padded[:2]] == [0, 1]
    assert all(r.is_pad for r in padded[2:])
    # clones must not share mutable state with the real requests
    padded[2].out_tokens.append(123)
    assert reqs[0].out_tokens == []


def test_pad_group_fills_tiny_tail_to_full_width():
    padded = pad_group([Request(0, np.zeros(4, np.int32), 8)], 8)
    assert len(padded) == 8
    assert sum(r.is_pad for r in padded) == 7


def test_pad_group_full_batch_unchanged():
    reqs = [Request(i, np.zeros(4, np.int32), 8) for i in range(4)]
    assert pad_group(reqs, 4) == reqs


def test_pad_group_empty_group_raises():
    with pytest.raises(ValueError, match="empty"):
        pad_group([], 4)


class CountingClock(TickClock):
    """TickClock that also counts how many times it was read."""

    def __init__(self, dt=0.25):
        super().__init__(dt=dt)
        self.reads = 0

    def __call__(self):
        self.reads += 1
        return super().__call__()


def _tick_server(batch=2):
    clock = CountingClock()
    ledger = GoodputLedger(window=60.0)
    server = Server(tsmoke("smollm-135m"), batch=batch, max_len=12,
                    ledger=ledger, clock=clock, device="cpu")
    reqs = [Request(i, np.full(8, i + 1, np.int32), 3, t_submit=0.0)
            for i in range(batch)]
    return server, ledger, clock, reqs


def test_server_rejects_bad_batches():
    with pytest.raises(ValueError, match="batch"):
        Server(tsmoke("smollm-135m"), batch=0, max_len=12, device="cpu")
    server, _, _, reqs = _tick_server(batch=2)
    with pytest.raises(ValueError, match="batch"):
        server.run_batch(reqs[:1])
    with pytest.raises(ValueError, match="real request"):
        server.run_batch([Request(-1, r.prompt, 3) for r in reqs])


def test_run_batch_reads_clock_three_times_and_tiles_the_batch():
    """Three reads a batch (start, prefill end, decode end); t_first and
    t_done land on the boundaries, and the slots' INIT / STEP / IDLE
    chip time is exactly batch x [t0, t2]."""
    server, ledger, clock, reqs = _tick_server(batch=3)
    server.run_batch(reqs)
    assert clock.reads == 3
    assert all(r.t_first == 0.5 and r.t_done == 0.75 for r in reqs)
    booked = sum(ledger.phase_chip_time(p)
                 for p in (Phase.INIT, Phase.STEP, Phase.IDLE))
    assert booked == pytest.approx(server.batch * 0.5)
    server.run_batch(reqs)
    assert clock.reads == 6
    assert server.batches == 2 and server.decode_steps == 4


def _requests(vocab, n=6, seed=3):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, vocab, PROMPT).astype(np.int32),
             int(rng.integers(2, MAX_NEW + 1))) for _ in range(n)]


def _run_both(arch, **torch_kw):
    jcfg, tcfg = jsmoke(arch), tsmoke(arch)
    shapes = _requests(jcfg.vocab_size)
    jreqs = [jserve.Request(i, p, m, t_submit=0.5 * i)
             for i, (p, m) in enumerate(shapes)]
    _, jout = jserve.run_static_server(jcfg, jreqs, BATCH, MAX_NEW, PROMPT,
                                       clock=jserve.TickClock(1.0))
    jp = jinit.init_params(jcfg, jax.random.key(0))
    params = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    treqs = [Request(i, p, m, t_submit=0.5 * i)
             for i, (p, m) in enumerate(shapes)]
    server, tout = run_static_server(tcfg, treqs, BATCH, MAX_NEW, PROMPT,
                                     clock=TickClock(1.0), params=params,
                                     device="cpu", **torch_kw)
    return jreqs, jout, treqs, tout, server


@pytest.mark.parametrize("arch", ["smollm-135m", "granite-3-8b", "qwen2-72b",
                                  "recurrentgemma-2b", "rwkv6-3b",
                                  "llava-next-mistral-7b", "whisper-medium"])
def test_static_server_matches_reference(arch):
    jreqs, jout, treqs, tout, server = _run_both(arch)
    for jr, tr in zip(jreqs, treqs):
        assert tr.out_tokens == jr.out_tokens, f"request {tr.rid}"
        assert (tr.t_first, tr.t_done) == (jr.t_first, jr.t_done)
    assert tout == jout
    assert tout["tokens_generated"] == sum(r.max_new for r in treqs)
    # two groups, the tail padded; each decodes its longest request
    assert server.batches == 2
    assert server.decode_steps == sum(
        max(r.max_new for r in treqs[g:g + BATCH]) - 1
        for g in range(0, len(treqs), BATCH))


def test_static_decode_eager_equals_auto():
    """``decode_impl="eager"`` (the graph's comparison on the card) gives
    the tokens and report of "auto", which is a direct call on the CPU;
    "graph" needs CUDA."""
    _, _, auto_reqs, auto_out, auto = _run_both("smollm-135m")
    _, _, eager_reqs, eager_out, eager = _run_both("smollm-135m",
                                                   decode_impl="eager")
    assert [r.out_tokens for r in eager_reqs] == \
        [r.out_tokens for r in auto_reqs]
    assert eager_out == auto_out
    for server in (auto, eager):
        stats = server.decode_graph_stats()
        assert stats["captures"] == 0 and stats["replays"] == 0
        assert stats["calls"] == server.decode_steps
    with pytest.raises(ValueError, match="CUDA"):
        Server(tsmoke("smollm-135m"), batch=2, max_len=12, device="cpu",
               decode_impl="graph")


def test_static_server_refuses_an_unknown_family():
    cfg = dataclasses.replace(tsmoke("smollm-135m"), family="rnn")
    with pytest.raises(ValueError, match="unknown model family"):
        Server(cfg, batch=2, max_len=12, device="cpu")


@pytest.mark.parametrize("arch", ["smollm-135m", "granite-3-8b",
                                  "llava-next-mistral-7b", "whisper-medium"])
def test_static_cli_matches_reference_cli(capsys, arch):
    argv = ["--arch", arch, "--smoke", "--engine", "static", "--requests",
            "7", "--batch", "3", "--prompt-len", "10", "--max-new", "4",
            "--tick-dt", "1"]
    out = tserve.main(argv + ["--device", "cpu"])
    capsys.readouterr()
    jserve.main(argv)
    ref = json.loads(capsys.readouterr().out)
    stats = out.pop("static_decode")
    assert out == ref
    assert out["tokens_generated"] == 7 * 4
    assert (stats["batches"], stats["decode_steps"]) == (3, 9)
