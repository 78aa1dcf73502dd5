"""The port's llava-next-mistral-7b (vlm: a dense decoder behind patch
embeddings) against the reference on the same weights (the JAX params
through ``params_from_numpy``), fp32 SMOKE on the CPU (8 patches, d 64):

* ``embed_inputs`` prepends the patches and returns their count, as the
  reference's does;
* ``prefill``'s logits and cache match ``transformer.prefill``, at a
  ``max_len`` that holds patches + prompt and at one that does not (the
  ring keeps the newest positions, dropping the patches first), with
  random patches;
* 10 greedy ``decode_step`` steps on that cache match the reference's
  (logits, tokens, the cache after): RoPE positions count the patches;
* ``model.input_specs`` gives the reference's vlm batch (tokens of s -
  num_patches, bf16 patches) and ``frontend_inputs`` the executors'
  zero patches.

Tolerance: logits atol/rtol 1e-4, caches 1e-5 (as ``test_torch_model.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke as jsmoke  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.models.config import ShapeConfig as JShape  # noqa: E402
from repro_torch.configs import get_smoke as tsmoke  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.models.config import ShapeConfig as TShape  # noqa: E402
from repro_torch.models.init import params_from_numpy  # noqa: E402

ARCH = "llava-next-mistral-7b"
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = jsmoke(ARCH), tsmoke(ARCH)
    jp = jmodel.init_params(jcfg, jax.random.key(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, tcfg, jp, tp


def _batches(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    patches = rng.standard_normal(
        (b, cfg.num_patches, cfg.d_model)).astype(np.float32)
    tokens = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    return ({"patches": jnp.asarray(patches), "tokens": jnp.asarray(tokens)},
            {"patches": torch.from_numpy(patches),
             "tokens": torch.from_numpy(tokens).long()})


def _assert_cache_close(tc, jc, tol):
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
    for name in ("k", "v"):
        np.testing.assert_allclose(tc["blocks"][name].numpy(),
                                   np.asarray(jc["blocks"][name]), **tol)


def test_embed_inputs_prepends_patches(setup):
    jcfg, tcfg, jp, tp = setup
    jb, tb = _batches(tcfg, 2, 5, 0)
    jx, jn = jtf.embed_inputs(jp, jb, jcfg)
    tx, tn = ttf.embed_inputs(tp, tb, tcfg)
    assert tn == jn == tcfg.num_patches
    assert tx.shape == (2, tcfg.num_patches + 5, tcfg.d_model)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), **TOL)


# max_len 30 holds 8 patches + 12 tokens + 10 new; 14 keeps only the
# newest 14 of the 20 prefill positions and wraps at every step
@pytest.mark.parametrize("max_len", [30, 14])
def test_prefill_and_decode_match_reference(setup, max_len):
    jcfg, tcfg, jp, tp = setup
    jb, tb = _batches(tcfg, 2, 12, max_len)
    jl, jc = jtf.prefill(jp, jb, jcfg, max_len=max_len)
    tl, tc = ttf.prefill(tp, tb, tcfg, max_len=max_len)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    assert tc["blocks"]["k"].shape[2] == max_len
    _assert_cache_close(tc, jc, TOL)
    assert (tc["pos"].numpy() == tcfg.num_patches + 12).all()
    decode = jax.jit(lambda p, t, c: jtf.decode_step(p, t, c, jcfg))
    jtok = jnp.argmax(jl, -1).astype(jnp.int32)
    ttok = tl.argmax(-1)
    for step in range(10):
        jl, jc = decode(jp, jtok, jc)
        out = tmodel.decode_inplace_fn(tcfg)(tp, ttok, tc)
        np.testing.assert_allclose(out.numpy(), np.asarray(jl), **LOGIT_TOL)
        jtok = jnp.argmax(jl, -1).astype(jnp.int32)
        ttok = out.argmax(-1)
        assert ttok.tolist() == np.asarray(jtok).tolist(), f"step {step}"
    _assert_cache_close(tc, jc, LOGIT_TOL)


def test_input_specs_and_frontend(setup):
    jcfg, tcfg, _, _ = setup
    shape = dict(name="prefill_32k", kind="prefill", seq_len=40,
                 global_batch=2)
    ref = jmodel.input_specs(jcfg, JShape(**shape))
    got = tmodel.input_specs(tcfg, TShape(**shape))
    assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
            for k, v in got.items()} == {
        k: (tuple(v.shape), np.dtype(v.dtype).name) for k, v in ref.items()}
    fe = tmodel.frontend_inputs(tcfg, 3)
    assert list(fe) == ["patches"] and fe["patches"].shape == (
        3, tcfg.num_patches, tcfg.d_model)
    assert fe["patches"].dtype == tcfg.compute_dtype
    assert not fe["patches"].any()
    assert tmodel.init_cache(tcfg, 1, 30)["blocks"]["k"].shape[2] == 30
