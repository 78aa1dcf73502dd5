"""The serving tree of ``compute_params`` against the raw tree, bf16
compute at SMOKE widths on the CPU, for smollm-135m, deepseek-moe-16b,
recurrentgemma-2b, rwkv6-3b, llava-next-mistral-7b and whisper-medium:

* ``prefill`` (with random patches / frames for vlm / enc-dec), one
  ``decode_step`` on its cache and (dense and MoE) one
  ``paged_decode_step`` over the scattered pages give logits and caches
  that are ``torch.equal`` to the raw tree's: the casts the model would
  make per call are made once, to the same values;
* the cast leaves are in the compute dtype and every other leaf (the
  router, the norms, ``lru_a``, conv weights, RWKV's mixing vectors,
  whisper's ``pos_dec``, of which a step casts only its rows, and its
  biases) is the very tensor of the raw tree; whisper's cross-attention
  matrices ``xattn.*`` are cast; the head is the compute-dtype operand
  ``lm_logits`` builds, in its layout (tied: a view of the cast table);
* with fp32 compute nothing is copied;
* both executors run on the cast tree, and the engine's tokens and
  ``ServeReport`` under a TickClock are those of the raw tree.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.launch.serve import TickClock  # noqa: E402
from repro_torch.models import model, transformer  # noqa: E402
from repro_torch.models.compute_params import CAST, compute_params  # noqa: E402,E501
from repro_torch.models.init import init_params  # noqa: E402
from repro_torch.serve.batched_executor import make_executor  # noqa: E402
from repro_torch.serve.engine import (ContinuousServeEngine,  # noqa: E402
                                      ServeRequest, ServeSLO)

ARCHS = ["smollm-135m", "deepseek-moe-16b", "recurrentgemma-2b", "rwkv6-3b",
         "llava-next-mistral-7b", "whisper-medium"]
PAGED = ["smollm-135m", "deepseek-moe-16b"]
MAX_LEN = 32


def _cfg(arch, dtype=torch.bfloat16):
    return dataclasses.replace(get_smoke(arch), compute_dtype=dtype)


def _params(cfg):
    return init_params(cfg, torch.Generator().manual_seed(0), "cpu")


def _leaves(tree, prefix=""):
    """{dotted path: tensor} of a nested dict / list / tuple tree."""
    if isinstance(tree, (list, tuple)):
        tree = {str(i): v for i, v in enumerate(tree)}
    if not isinstance(tree, dict):
        return {prefix: tree}
    out = {}
    for k, v in tree.items():
        out.update(_leaves(v, f"{prefix}.{k}" if prefix else k))
    return out


def _assert_equal_trees(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert la.keys() == lb.keys()
    for name, t in la.items():
        assert torch.equal(t, lb[name]), name


def _prompt(cfg, seed, n=13):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, n)))


@pytest.mark.parametrize("arch", ARCHS)
def test_cast_tree_prefill_and_decode_are_bit_identical(arch):
    cfg = _cfg(arch)
    raw = _params(cfg)
    cast = compute_params(raw, cfg)
    gen = torch.Generator().manual_seed(1)
    batch = {"tokens": _prompt(cfg, 1),
             **{k: torch.randn(v.shape, generator=gen).to(v.dtype)
                for k, v in model.frontend_inputs(cfg, 2).items()}}
    prefill = model.prefill_fn(cfg, max_len=MAX_LEN)
    with torch.inference_mode():
        outs = [prefill(p, batch) for p in (raw, cast)]
        assert outs[0][0].dtype == torch.float32
        assert torch.equal(outs[0][0], outs[1][0])
        _assert_equal_trees(outs[0][1], outs[1][1])
        tok = outs[0][0].argmax(-1)
        steps = [model.decode_fn(cfg)(p, tok, cache)
                 for p, (_, cache) in zip((raw, cast), outs)]
    assert torch.equal(steps[0][0], steps[1][0])
    _assert_equal_trees(steps[0][1], steps[1][1])


@pytest.mark.parametrize("arch", PAGED)
def test_cast_tree_paged_decode_is_bit_identical(arch):
    cfg = _cfg(arch)
    raw = _params(cfg)
    cast = compute_params(raw, cfg)
    bt, nb, n = 8, 3, 13
    prompts = _prompt(cfg, 2, n)
    tables = torch.arange(2 * nb, dtype=torch.int32).reshape(2, nb)
    res = []
    with torch.inference_mode():
        for p in (raw, cast):
            kp = torch.zeros(transformer.paged_kv_shape(cfg, 2 * nb, bt),
                             dtype=cfg.compute_dtype)
            vp = torch.zeros_like(kp)
            toks = []
            for row in range(2):
                logits, cache = transformer.prefill(
                    p, {"tokens": prompts[row:row + 1]}, cfg,
                    max_len=bt * nb)
                pos = torch.arange(n)
                transformer.scatter_prefill_pages(
                    cache, cfg, kp, vp, tables[row].long()[pos // bt],
                    pos % bt)
                toks.append(logits.argmax(-1))
            lengths = torch.full((2,), n + 1, dtype=torch.int32)
            res.append(transformer.paged_decode_step(
                p, torch.cat(toks), lengths, kp, vp, tables, cfg))
    for a, b in zip(*res):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ARCHS)
def test_cast_leaves_and_shared_leaves(arch):
    cfg = _cfg(arch)
    raw = _params(cfg)
    cast = compute_params(raw, cfg)
    lr, lc = _leaves(raw), _leaves(cast)
    assert lc.keys() == lr.keys() | {"head"}
    for name, t in lr.items():
        if name.split(".")[-1] in CAST:
            assert lc[name].dtype == cfg.compute_dtype, name
            assert torch.equal(lc[name], t.to(cfg.compute_dtype)), name
        else:
            assert lc[name] is t, name
    # the leaves the model reads in fp32 stay the raw tensors
    kept = {"final_norm"}
    if cfg.family == "moe":
        kept |= {"blocks.moe.router", "blocks.ln1", "blocks.ln2"}
    if cfg.family == "hybrid":
        rec = next(k for k in lr if k.endswith("rec.lru_a"))
        kept |= {rec, rec.replace("lru_a", "conv_w"), "layers.0.ln1"}
    if cfg.family == "ssm":
        kept |= {"blocks.tm.mix", "blocks.cm.mix", "blocks.tm.decay_a",
                 "blocks.ln1"}
    if cfg.family == "encdec":
        kept |= {"embed.pos_dec", "final_norm_enc", "final_norm_enc_b",
                 "dec_blocks.ln_x", "dec_blocks.ln_x_b",
                 "dec_blocks.xattn.bk", "enc_blocks.attn.bq"}
        for w in ("wq", "wk", "wv", "wo"):
            assert lc[f"dec_blocks.xattn.{w}"].dtype == cfg.compute_dtype
    for name in kept:
        assert lr[name].dtype == torch.float32 and lc[name] is lr[name], name
    w = (raw["embed"]["tok"].T if cfg.tie_embeddings else raw["lm_head"])
    head = cast["head"]
    assert head.dtype == cfg.compute_dtype
    assert torch.equal(head, w.to(cfg.compute_dtype))
    assert head.stride() == w.stride()
    if cfg.tie_embeddings:      # a view of the cast table, no copy
        assert head.data_ptr() == lc["embed.tok"].data_ptr()


@pytest.mark.parametrize("arch", ARCHS)
def test_fp32_compute_copies_nothing(arch):
    cfg = _cfg(arch, torch.float32)
    raw = _params(cfg)
    cast = compute_params(raw, cfg)
    lr, lc = _leaves(raw), _leaves(cast)
    assert all(lc[name] is t for name, t in lr.items())
    tok = raw["embed"]["tok"]
    if cfg.tie_embeddings:
        assert cast["head"].data_ptr() == tok.data_ptr()
        assert torch.equal(cast["head"], tok.T)
    else:
        assert cast["head"] is raw["lm_head"]


def _serve(cfg, raw_tree: bool):
    rng = np.random.default_rng(3)
    reqs = [ServeRequest(rid=i, prompt_len=n, max_new=int(m), t_submit=0.0,
                         prompt=rng.integers(0, cfg.vocab_size, n)
                         .astype(np.int32))
            for i, (n, m) in enumerate([(7, 5), (12, 3), (5, 8), (9, 4),
                                        (11, 6)])]
    ex, kv = make_executor(cfg, MAX_LEN, 3, clock=TickClock(1.0),
                           device="cpu", params=_params(cfg))
    if raw_tree:
        ex.serving_params = ex.params
    rep = ContinuousServeEngine(3, ex, slo=ServeSLO(ttft=6.0, tpot=2.0),
                                kv_cache=kv).run(reqs)
    return ex, [r.out_tokens for r in reqs], rep.as_dict()


@pytest.mark.parametrize("arch", ARCHS)
def test_executor_runs_the_cast_tree_with_the_same_report(arch):
    cfg = _cfg(arch)
    ex, toks, rep = _serve(cfg, raw_tree=False)
    assert "head" in ex.serving_params and "head" not in ex.params
    assert ex.serving_params["final_norm"] is ex.params["final_norm"]
    _, raw_toks, raw_rep = _serve(cfg, raw_tree=True)
    assert toks == raw_toks and sum(map(len, toks)) == 26
    assert rep == raw_rep


def _without_lm_head(tree):
    return {k: v for k, v in tree.items() if k != "lm_head"}


@pytest.mark.parametrize("arch", ARCHS)
def test_consume_frees_the_raw_tree_as_it_casts(arch):
    """``consume=True`` gives the same tree (less ``lm_head``, whose use
    ``head`` took over) and leaves ``params`` empty; the leaves it does
    not cast are still the raw tensors."""
    cfg = _cfg(arch)
    ref = compute_params(_params(cfg), cfg)
    raw = _params(cfg)
    before = _leaves(raw)
    out = compute_params(raw, cfg, consume=True)
    assert raw == {}
    _assert_equal_trees(out, _without_lm_head(ref))
    for name, t in _leaves(out).items():
        if name in before and name.split(".")[-1] not in CAST:
            assert t is before[name], name


@pytest.mark.parametrize("arch", ARCHS)
def test_executor_that_draws_keeps_only_the_cast_tree(arch):
    cfg = _cfg(arch)
    ex, _ = make_executor(cfg, MAX_LEN, 3, clock=TickClock(1.0),
                          device="cpu")
    assert ex.params is None
    _assert_equal_trees(ex.serving_params,
                        _without_lm_head(compute_params(_params(cfg), cfg)))
