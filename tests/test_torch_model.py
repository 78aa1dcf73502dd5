"""The port's model against the reference on the same weights (the JAX
params through ``params_from_numpy``), fp32 SMOKE on the CPU, for
smollm-135m, qwen2.5-14b (QKV bias) and deepseek-moe-16b (a dense first
layer, then MoE blocks with shared experts):

* ``prefill`` logits and the decode cache match ``transformer.prefill``;
* ``scatter_prefill_pages`` then 8 steps of ``paged_decode_step`` match
  the reference's paged decode step by step, with the same greedy tokens.

Tolerance: logits atol/rtol 1e-4 (fp32 through a few layers in another
summation order; the acceptance bound), cache 1e-5.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke as jsmoke  # noqa: E402
from repro.models import init as jinit  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch.configs import get_smoke as tsmoke  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.models.init import params_from_numpy  # noqa: E402

ARCHS = ["smollm-135m", "qwen2.5-14b", "deepseek-moe-16b"]
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)


def _setup(arch):
    jcfg, tcfg = jsmoke(arch), tsmoke(arch)
    jp = jinit.init_params(jcfg, jax.random.key(0))
    if tcfg.qkv_bias:      # zero-initialised: give the bias path some work
        rng = np.random.default_rng(1)
        attn = dict(jp["blocks"]["attn"])
        for name in ("bq", "bk", "bv"):
            attn[name] = jnp.asarray(
                0.1 * rng.standard_normal(attn[name].shape), jnp.float32)
        jp = {**jp, "blocks": {**jp["blocks"], "attn": attn}}
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, tcfg, jp, tp


@pytest.mark.parametrize("seq", [13, 16])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_and_cache_match_reference(arch, seq):
    """seq 16 takes the reference's chunked attention (chunk 8), 13 its
    unchunked path; the port runs the same plain flash version."""
    jcfg, tcfg, jp, tp = _setup(arch)
    tok = np.random.default_rng(seq).integers(
        0, tcfg.vocab_size, (2, seq)).astype(np.int32)
    jl, jc = jtf.prefill(jp, {"tokens": jnp.asarray(tok)}, jcfg, max_len=24)
    tl, tc = ttf.prefill(tp, {"tokens": torch.from_numpy(tok)}, tcfg,
                         max_len=24)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    assert tc["pos"].tolist() == np.asarray(jc["pos"]).tolist()
    assert tc.keys() == jc.keys()
    layers = [(tc["blocks"], jc["blocks"])] + [
        (tc["dense_layers"][i], jc["dense_layers"][i])
        for i in jc.get("dense_layers", {})]
    for t, j in layers:
        for name in ("k", "v"):
            assert tuple(t[name].shape) == j[name].shape
            np.testing.assert_allclose(t[name].numpy(), np.asarray(j[name]),
                                       atol=1e-5, rtol=1e-5)


def test_ring_place_matches_reference():
    x = np.arange(2 * 7 * 3, dtype=np.float32).reshape(2, 7, 3)
    for seq_end, slots in ((7, 10), (7, 4), (9, 5), (7, 7)):
        ref = np.asarray(jtf.ring_place(jnp.asarray(x), seq_end, slots, 1))
        got = ttf.ring_place(torch.from_numpy(x), seq_end, slots, 1).numpy()
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_decode_matches_reference(arch):
    """Three rows (prompts of 5 and 12 tokens, one inactive row on the
    null page), 8-token pages so decode crosses a page boundary, 8 greedy
    steps: logits per step and every sampled token agree."""
    jcfg, tcfg, jp, tp = _setup(arch)
    bt, nb, n_rows = 8, 3, 3
    null = n_rows * nb
    shape = ttf.paged_kv_shape(tcfg, null + 1, bt)
    assert shape == jtf.paged_kv_shape(jcfg, null + 1, bt)
    jk = jnp.zeros(shape, jnp.float32)
    jv = jnp.zeros(shape, jnp.float32)
    tk = torch.zeros(shape)
    tv = torch.zeros(shape)
    tables = np.full((n_rows, nb), null, np.int32)
    tables[0], tables[1] = [4, 0, 7], [2, 5, 1]
    lengths = np.zeros((n_rows,), np.int32)
    tok = np.zeros((n_rows,), np.int32)
    rng = np.random.default_rng(7)
    for row, plen in ((0, 5), (1, 12)):
        prompt = rng.integers(0, tcfg.vocab_size, (1, plen)).astype(np.int32)
        jl, jc = jtf.prefill(jp, {"tokens": jnp.asarray(prompt)}, jcfg,
                             max_len=nb * bt)
        tl, tc = ttf.prefill(tp, {"tokens": torch.from_numpy(prompt)}, tcfg,
                             max_len=nb * bt)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
        pos = np.arange(plen)
        pg = tables[row][pos // bt].astype(np.int32)
        off = (pos % bt).astype(np.int32)
        jk, jv = jtf.scatter_prefill_pages(jc, jcfg, jk, jv, jnp.asarray(pg),
                                           jnp.asarray(off))
        ttf.scatter_prefill_pages(tc, tcfg, tk, tv, torch.from_numpy(pg),
                                  torch.from_numpy(off))
        lengths[row] = plen
        tok[row] = int(np.argmax(np.asarray(jl)[0]))
        assert tok[row] == int(tl[0].argmax())
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=1e-5,
                               rtol=1e-5)

    for _ in range(8):
        lengths[:2] += 1                      # the engine's append_token
        jlog, jk, jv = jtf.paged_decode_step(
            jp, jnp.asarray(tok), jnp.asarray(lengths), jk, jv,
            jnp.asarray(tables), jcfg, attn_impl="ref")
        tlog, _, _ = ttf.paged_decode_step(
            tp, torch.from_numpy(tok), torch.from_numpy(lengths), tk, tv,
            torch.from_numpy(tables), tcfg)
        jlog = np.asarray(jlog)
        np.testing.assert_allclose(tlog.numpy()[:2], jlog[:2], **LOGIT_TOL)
        nxt = tlog.argmax(-1).numpy().astype(np.int32)
        assert nxt[:2].tolist() == jlog[:2].argmax(-1).tolist()
        tok = nxt
    assert lengths[1] == 20                   # crossed into the third page
