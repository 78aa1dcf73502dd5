"""The port's whisper-medium (enc-dec) against the reference on the same
weights (the JAX params through ``params_from_numpy``), fp32 SMOKE on the
CPU:

* ``encode`` (24 encoder positions at SMOKE) matches ``whisper.encode``,
  and ``_sinusoid`` the reference's table;
* ``prefill``'s logits and cache match ``whisper.prefill``: the ring of
  prompt + 64 slots in the first slots of the port's buffer, zeros after;
  ``pos`` and ``ring`` per row;
* 8 steps of ``decode_step_inplace`` fed the reference's greedy tokens
  match ``whisper.decode_step`` logit for logit, the cache after too;
* 70 greedy steps from a 5-token prompt cross the 69-slot ring (the
  reference attends to the last prompt + 64 positions only): the same
  tokens, the logits close at every step;
* ``cross_attention`` (non-causal, 5 or 1 queries against the encoder's
  keys) matches the reference's, and the flash plain version the
  Pallas kernel in interpret mode at sq != skv, non-causal;
* ``model.prefill_fn`` / ``decode_inplace_fn`` / ``init_cache`` dispatch
  enc-dec to ``whisper``; a buffer shorter than the ring is refused.

Tolerance: logits atol/rtol 1e-4 (fp32 through 2 + 2 layers in another
summation order, the acceptance bound of ``test_torch_model.py``);
encoder states, caches and attention outputs 1e-5.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke as jsmoke  # noqa: E402
from repro.kernels.flash_attention.ops import \
    flash_attention_bshd as pallas_bshd  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models import whisper as jw  # noqa: E402
from repro_torch.configs import get_smoke as tsmoke  # noqa: E402
from repro_torch.kernels.flash_attention.ops import \
    flash_attention_bshd  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models import whisper as tw  # noqa: E402
from repro_torch.models.init import params_from_numpy  # noqa: E402

ARCH = "whisper-medium"
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = jsmoke(ARCH), tsmoke(ARCH)
    jp = jmodel.init_params(jcfg, jax.random.key(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, tcfg, jp, tp


def _inputs(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    frames = rng.standard_normal(
        (b, cfg.encoder_positions, cfg.d_model)).astype(np.float32)
    tokens = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    return frames, tokens


def _prefill_both(setup, b, s, seed, max_len=0):
    jcfg, tcfg, jp, tp = setup
    frames, tokens = _inputs(tcfg, b, s, seed)
    jl, jc = jw.prefill(jp, {"frames": jnp.asarray(frames),
                             "tokens": jnp.asarray(tokens)}, jcfg)
    tl, tc = tw.prefill(tp, {"frames": torch.from_numpy(frames),
                             "tokens": torch.from_numpy(tokens).long()},
                        tcfg, max_len=max_len)
    return jl, jc, tl, tc


def _jit_decode(cfg):
    """The reference's decode step, compiled once (its fori_loop traces
    anew on every eager call)."""
    return jax.jit(lambda p, t, c: jw.decode_step(p, t, c, cfg))


def _assert_cache_close(tc, jc, tol):
    """The port's cache against the reference's: pos per row, the ring's
    length, the ring in the buffer's first slots and zeros after it, the
    encoder states."""
    ring = jc["blocks"]["k"].shape[2]
    assert (tc["pos"].numpy() == int(jc["pos"])).all()
    assert (tc["ring"].numpy() == ring).all()
    for name in ("k", "v"):
        t = tc["blocks"][name].numpy()
        np.testing.assert_allclose(t[:, :, :ring],
                                   np.asarray(jc["blocks"][name]), **tol)
        assert not t[:, :, ring:].any()
    np.testing.assert_allclose(tc["enc_out"].numpy(),
                               np.asarray(jc["enc_out"]), **tol)


def test_sinusoid_matches_reference():
    """At SMOKE's 24 positions within 1e-5.  At the encoder's 1500 the
    angles t = position x frequency reach ~1500, where one ulp of a
    frequency (exp rounds it either way: the reference's own eager and
    jitted tables differ so) moves t, and sin / cos, by up to 1500 x
    2^-24 x 2 = 1.8e-4: held to 2.5e-4, and the reference's jitted table
    differs from its eager one by a like amount."""
    np.testing.assert_allclose(tw._sinusoid(24, 64).numpy(),
                               np.asarray(jw._sinusoid(24, 64)), **TOL)
    ref = np.asarray(jw._sinusoid(1500, 1024))
    jit = np.asarray(jax.jit(lambda: jw._sinusoid(1500, 1024))())
    assert np.abs(jit - ref).max() > 2e-5
    np.testing.assert_allclose(tw._sinusoid(1500, 1024).numpy(), ref,
                               atol=2.5e-4, rtol=0)


def test_encode_matches_reference(setup):
    jcfg, tcfg, jp, tp = setup
    frames, _ = _inputs(tcfg, 2, 1, 0)
    ref = np.asarray(jw.encode(jp, jnp.asarray(frames), jcfg))
    out = tw.encode(tp, torch.from_numpy(frames), tcfg)
    assert out.shape == (2, tcfg.encoder_positions, tcfg.d_model)
    np.testing.assert_allclose(out.numpy(), ref, **TOL)


@pytest.mark.parametrize("s,max_len", [(5, 0), (12, 0), (7, 90)])
def test_prefill_logits_and_cache_match_reference(setup, s, max_len):
    jl, jc, tl, tc = _prefill_both(setup, 2, s, s, max_len)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    assert tc["blocks"]["k"].shape[2] == (max_len or s + tw.RING_EXTRA)
    _assert_cache_close(tc, jc, TOL)


def test_decode_steps_match_reference(setup):
    """8 steps, both sides fed the reference's greedy tokens, the port's
    cache in a buffer of 90 slots around the 71-slot ring."""
    jcfg, tcfg, jp, tp = setup
    jl, jc, tl, tc = _prefill_both(setup, 2, 7, 3, max_len=90)
    decode = _jit_decode(jcfg)
    tok = jnp.argmax(jl, -1).astype(jnp.int32)
    for _ in range(8):
        out = tw.decode_step_inplace(
            tp, torch.from_numpy(np.array(tok)), tc, tcfg)
        jl, jc = decode(jp, tok, jc)
        np.testing.assert_allclose(out.numpy(), np.asarray(jl), **LOGIT_TOL)
        tok = jnp.argmax(jl, -1).astype(jnp.int32)
    _assert_cache_close(tc, jc, TOL)


def test_greedy_decode_crosses_the_ring(setup):
    """70 greedy steps from a 5-token prompt: the reference's ring holds
    69 slots, so the last steps overwrite the oldest positions; the port
    must do the same in its longer buffer (here 100 slots)."""
    jcfg, tcfg, jp, tp = setup
    jl, jc, tl, tc = _prefill_both(setup, 1, 5, 7, max_len=100)
    decode = _jit_decode(jcfg)
    jtok = jnp.argmax(jl, -1).astype(jnp.int32)
    ttok = tl.argmax(-1)
    assert int(ttok[0]) == int(jtok[0])
    for step in range(70):
        out = tw.decode_step_inplace(tp, ttok, tc, tcfg)
        jl, jc = decode(jp, jtok, jc)
        np.testing.assert_allclose(out.numpy(), np.asarray(jl), **LOGIT_TOL)
        jtok = jnp.argmax(jl, -1).astype(jnp.int32)
        ttok = out.argmax(-1)
        assert int(ttok[0]) == int(jtok[0]), f"step {step}"
    assert int(tc["pos"][0]) == 75 > int(tc["ring"][0]) == 69
    _assert_cache_close(tc, jc, LOGIT_TOL)


@pytest.mark.parametrize("s", [1, 5])
def test_cross_attention_matches_reference(setup, s):
    jcfg, tcfg, jp, tp = setup
    rng = np.random.default_rng(s)
    x = rng.standard_normal((2, s, tcfg.d_model)).astype(np.float32)
    t = tcfg.encoder_positions
    k, v = (rng.standard_normal((2, t, tcfg.num_kv_heads, tcfg.head_dim))
            .astype(np.float32) for _ in range(2))
    jp0 = jax.tree.map(lambda a: a[0], jp["dec_blocks"]["xattn"])
    tp0 = {n: a[0] for n, a in tp["dec_blocks"]["xattn"].items()}
    ref = jattn.cross_attention(jnp.asarray(x), jp0, jcfg, jnp.asarray(k),
                                jnp.asarray(v))
    out = tattn.cross_attention(torch.from_numpy(x), tp0, tcfg,
                                torch.from_numpy(k), torch.from_numpy(v),
                                attn_impl="ref")
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


# (sq, skv): decode (1 query), a prompt, and skv past one 24-key tile
@pytest.mark.parametrize("sq,skv", [(1, 24), (5, 24), (7, 37), (24, 24)])
def test_flash_plain_matches_pallas_noncausal(sq, skv):
    """The flash path the model runs (``flash_attention_bshd``, the plain
    version on the CPU) against the reference's Pallas kernel in
    interpret mode, non-causal, sq != skv; the kernel's tiles are
    min(128, s) rows, so no tile reads past the end."""
    rng = np.random.default_rng(sq * 100 + skv)
    q = rng.standard_normal((2, sq, 4, 16)).astype(np.float32)
    k, v = (rng.standard_normal((2, skv, 4, 16)).astype(np.float32)
            for _ in range(2))
    ref = pallas_bshd(*(jnp.asarray(a) for a in (q, k, v)), causal=False,
                      interpret=True)
    out = flash_attention_bshd(*(torch.from_numpy(a) for a in (q, k, v)),
                               causal=False, impl="ref")
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_model_dispatch_and_refusals(setup):
    jcfg, tcfg, jp, tp = setup
    frames, tokens = _inputs(tcfg, 1, 6, 11)
    batch = {"frames": torch.from_numpy(frames),
             "tokens": torch.from_numpy(tokens).long()}
    logits, cache = tmodel.prefill_fn(tcfg, max_len=80)(tp, batch)
    direct, _ = tw.prefill(tp, batch, tcfg, max_len=80)
    assert torch.equal(logits, direct)
    # a server of 80-token requests: room for the prompt + 64 ring
    assert cache["blocks"]["k"].shape[2] == 80 + tw.RING_EXTRA
    blank = tmodel.init_cache(tcfg, 1, 80)
    assert {k: tuple(v.shape) for k, v in blank["blocks"].items()} == {
        k: tuple(v.shape) for k, v in cache["blocks"].items()}
    assert blank.keys() == cache.keys()
    assert int(blank["ring"][0]) == 80 + tw.RING_EXTRA
    out = tmodel.decode_inplace_fn(tcfg)(tp, logits.argmax(-1), cache)
    assert out.shape == (1, tcfg.vocab_size) and int(cache["pos"][0]) == 7
    fe = tmodel.frontend_inputs(tcfg, 3)
    assert list(fe) == ["frames"] and fe["frames"].shape == (
        3, tcfg.encoder_positions, tcfg.d_model) and not fe["frames"].any()
    with pytest.raises(ValueError, match="ring"):
        tw.prefill(tp, batch, tcfg, max_len=60)
