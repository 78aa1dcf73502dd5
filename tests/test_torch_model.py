"""The port's model against the reference on the same weights (the JAX
params through ``params_from_numpy``), fp32 SMOKE on the CPU, for
smollm-135m, qwen2.5-14b (QKV bias), granite-3-8b, qwen2-72b (QKV
bias), deepseek-moe-16b (a dense first layer, then MoE blocks with shared
experts), recurrentgemma-2b (RG-LRU + windowed MQA attention) and
rwkv6-3b:

* ``prefill`` logits and the decode cache match ``transformer.prefill``;
* ``scatter_prefill_pages`` then 8 steps of ``paged_decode_step`` match
  the reference's paged decode step by step, with the same greedy tokens
  (dense and MoE);
* 22 greedy steps of ``decode_step`` on the prefill cache match the
  reference's ``decode_step`` (logits, tokens, the cache after), for
  recurrentgemma (the 16-slot attention ring wraps), rwkv6 (prompts of 40
  and 128: the reference's per-token and chunked WKV), mixtral (a
  16-token window, per-row ``pos``), granite and qwen2-72b (per-row
  ``pos``, the static server's decode) and smollm (a scalar ``pos``);
* ``init_cache`` gives the reference's tree, shapes and dtypes.

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

ARCHS = ["smollm-135m", "qwen2.5-14b", "granite-3-8b", "qwen2-72b",
         "deepseek-moe-16b"]
PREFILL_ARCHS = ARCHS + ["recurrentgemma-2b", "rwkv6-3b"]
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)


def _flat(tree, prefix=""):
    if isinstance(tree, (list, tuple)):
        tree = {str(i): v for i, v in enumerate(tree)}
    out = {}
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else k
        out.update(_flat(v, name) if isinstance(v, (dict, list, tuple))
                   else {name: v})
    return out


def _assert_caches_close(tc, jc, tol):
    t, j = _flat(tc), _flat(jc)
    assert t.keys() == j.keys()
    for name in j:
        assert tuple(t[name].shape) == j[name].shape, name
        assert str(t[name].dtype).split(".")[-1] == np.dtype(
            j[name].dtype).name, name
        np.testing.assert_allclose(t[name].numpy(), np.asarray(j[name]),
                                   err_msg=name, **tol)


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
@pytest.mark.parametrize("arch", PREFILL_ARCHS)
def test_prefill_logits_and_cache_match_reference(arch, seq):
    """seq 16 takes the reference's chunked attention (chunk 8), 13 its
    unchunked path; the port runs the same plain flash version.  The
    cache 1e-5, the RWKV-6 WKV states 1e-4 (hundreds of summed outer
    products, in another order)."""
    jcfg, tcfg, jp, tp = _setup(arch)
    tok = np.random.default_rng(seq).integers(
        0, tcfg.vocab_size, (2, seq)).astype(np.int32)
    jl, jc = jtf.prefill(jp, {"tokens": jnp.asarray(tok)}, jcfg, max_len=24)
    tl, tc = ttf.prefill(tp, {"tokens": torch.from_numpy(tok)}, tcfg,
                         max_len=24)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    assert tc["pos"].tolist() == np.asarray(jc["pos"]).tolist()
    tol = (LOGIT_TOL if tcfg.family == "ssm" else dict(atol=1e-5, rtol=1e-5))
    _assert_caches_close(tc, jc, tol)


@pytest.mark.parametrize("arch,seq,scalar_pos", [
    ("recurrentgemma-2b", 13, False), ("rwkv6-3b", 40, False),
    ("rwkv6-3b", 128, False), ("mixtral-8x7b", 10, False),
    ("granite-3-8b", 11, False), ("qwen2-72b", 11, False),
    ("smollm-135m", 9, True)])
def test_decode_step_matches_reference(arch, seq, scalar_pos):
    jcfg, tcfg, jp, tp = _setup(arch)
    tok = np.random.default_rng(seq).integers(
        0, tcfg.vocab_size, (1, seq)).astype(np.int32)
    max_len = seq + 24
    jl, jc = jtf.prefill(jp, {"tokens": jnp.asarray(tok)}, jcfg,
                         max_len=max_len)
    tl, tc = ttf.prefill(tp, {"tokens": torch.from_numpy(tok)}, tcfg,
                         max_len=max_len)
    if scalar_pos:
        jc = {**jc, "pos": jnp.asarray(seq, jnp.int32)}
        tc = {**tc, "pos": torch.tensor(seq, dtype=torch.int32)}
    step = jax.jit(lambda p, t, c: jtf.decode_step(p, t, c, jcfg))
    nxt = np.asarray(jl).argmax(-1).astype(np.int32)
    assert nxt.tolist() == tl.argmax(-1).tolist()
    for _ in range(22):
        jl, jc = step(jp, jnp.asarray(nxt), jc)
        tl, tc = ttf.decode_step(tp, torch.from_numpy(nxt).long(), tc, tcfg)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
        nxt = np.asarray(jl).argmax(-1).astype(np.int32)
        assert nxt.tolist() == tl.argmax(-1).tolist()
    assert np.asarray(tc["pos"]).tolist() == np.asarray(jc["pos"]).tolist()
    _assert_caches_close(tc, jc, LOGIT_TOL)


@pytest.mark.parametrize("arch", PREFILL_ARCHS + ["mixtral-8x7b"])
def test_init_cache_matches_reference(arch):
    jcfg, tcfg = jsmoke(arch), tsmoke(arch)
    for seq_len in (8, 40):
        ref = {k: (a.shape, np.dtype(a.dtype).name) for k, a in
               _flat(jtf.init_cache(jcfg, 2, seq_len, abstract=True))
               .items()}
        got = {k: (tuple(t.shape), str(t.dtype).split(".")[-1]) for k, t in
               _flat(ttf.init_cache(tcfg, 2, seq_len)).items()}
        assert got == ref


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
