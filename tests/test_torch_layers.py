"""Port layers against the reference's, function by function, on the same
numpy inputs in fp32 on the CPU.

Tolerance 1e-5 (atol and rtol): the same fp32 arithmetic, summed in
another order by another library's kernels.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke as jsmoke  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro_torch.configs import get_smoke as tsmoke  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)


def _rand(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _both(a):
    return jnp.asarray(a), torch.from_numpy(a)


def _close(j, t, **tol):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                               **(tol or TOL))


def test_rmsnorm_layernorm_norm():
    rng = np.random.default_rng(0)
    x, w, b = _rand(rng, 2, 5, 48), _rand(rng, 48), _rand(rng, 48)
    (jx, tx), (jw, tw), (jb, tb) = _both(x), _both(w), _both(b)
    _close(jl.rmsnorm(jx, jw, 1e-6), tl.rmsnorm(tx, tw, 1e-6))
    _close(jl.layernorm(jx, jw, jb, 1e-5), tl.layernorm(tx, tw, tb, 1e-5))
    cfg_j, cfg_t = jsmoke("smollm-135m"), tsmoke("smollm-135m")
    _close(jl.norm(jx, {"ln1": jw}, "ln1", cfg_j),
           tl.norm(tx, {"ln1": tw}, "ln1", cfg_t))
    ln_j = dataclasses.replace(cfg_j, norm_type="layernorm")
    ln_t = dataclasses.replace(cfg_t, norm_type="layernorm")
    _close(jl.norm(jx, {"ln1": jw, "ln1_b": jb}, "ln1", ln_j),
           tl.norm(tx, {"ln1": tw, "ln1_b": tb}, "ln1", ln_t))


def test_dense_with_and_without_bias():
    rng = np.random.default_rng(1)
    x, w, b = _rand(rng, 3, 4, 48), _rand(rng, 48, 80), _rand(rng, 80)
    (jx, tx), (jw, tw), (jb, tb) = _both(x), _both(w), _both(b)
    _close(jl.dense(jx, jw), tl.dense(tx, tw))
    _close(jl.dense(jx, jw, jb), tl.dense(tx, tw, tb))


@pytest.mark.parametrize("act,gated", [("silu", True), ("gelu", True),
                                       ("silu", False)])
def test_mlp(act, gated):
    rng = np.random.default_rng(2)
    cfg_j = dataclasses.replace(jsmoke("smollm-135m"), mlp_activation=act,
                                mlp_gated=gated)
    cfg_t = dataclasses.replace(tsmoke("smollm-135m"), mlp_activation=act,
                                mlp_gated=gated)
    d, ff = cfg_t.d_model, cfg_t.d_ff
    x = _rand(rng, 2, 3, d)
    p = {"wi": _rand(rng, d, ff, scale=0.2), "wo": _rand(rng, ff, d, scale=0.2)}
    if gated:
        p["wg"] = _rand(rng, d, ff, scale=0.2)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    _close(jl.mlp(jnp.asarray(x), jp, cfg_j),
           tl.mlp(torch.from_numpy(x), tp, cfg_t))


@pytest.mark.parametrize("theta", [10_000.0, 1e6])
def test_rope_half_split(theta):
    rng = np.random.default_rng(3)
    x = _rand(rng, 2, 7, 3, 16)
    pos = rng.integers(0, 300, (2, 7)).astype(np.int32)
    _close(jl.rope(jnp.asarray(x), jnp.asarray(pos), theta),
           tl.rope(torch.from_numpy(x), torch.from_numpy(pos), theta))


def test_embed_tokens():
    rng = np.random.default_rng(4)
    w = _rand(rng, 128, 48)
    tok = rng.integers(0, 128, (2, 9)).astype(np.int32)
    out = tl.embed_tokens(torch.from_numpy(tok), torch.from_numpy(w),
                          torch.float32)
    _close(jl.embed_tokens(jnp.asarray(tok), jnp.asarray(w), jnp.float32),
           out, atol=0, rtol=0)


@pytest.mark.parametrize("tied,softcap", [(True, 0.0), (False, 0.0),
                                          (False, 30.0)])
def test_lm_logits(tied, softcap):
    rng = np.random.default_rng(5)
    cfg_j = dataclasses.replace(jsmoke("qwen2.5-14b"), tie_embeddings=tied)
    cfg_t = dataclasses.replace(tsmoke("qwen2.5-14b"), tie_embeddings=tied)
    d, vocab = cfg_t.d_model, cfg_t.vocab_size
    x = _rand(rng, 3, d)
    p = {"embed": {"tok": _rand(rng, vocab, d)},
         "lm_head": _rand(rng, d, vocab)}
    jp = {"embed": {"tok": jnp.asarray(p["embed"]["tok"])},
          "lm_head": jnp.asarray(p["lm_head"])}
    tp = {"embed": {"tok": torch.from_numpy(p["embed"]["tok"])},
          "lm_head": torch.from_numpy(p["lm_head"])}
    out = tl.lm_logits(torch.from_numpy(x), tp, cfg_t, softcap=softcap)
    assert out.dtype == torch.float32
    _close(jl.lm_logits(jnp.asarray(x), jp, cfg_j, softcap=softcap), out)


def test_lm_logits_bf16_inputs_give_fp32_logits():
    """bf16 activations and weights multiply with fp32 accumulation into
    fp32 logits, as the reference's preferred_element_type=float32."""
    rng = np.random.default_rng(6)
    cfg_j = dataclasses.replace(jsmoke("smollm-135m"),
                                compute_dtype=jnp.bfloat16)
    cfg_t = dataclasses.replace(tsmoke("smollm-135m"),
                                compute_dtype=torch.bfloat16)
    x = _rand(rng, 2, cfg_t.d_model)
    w = _rand(rng, cfg_t.vocab_size, cfg_t.d_model)
    j = jl.lm_logits(jnp.asarray(x, jnp.bfloat16),
                     {"embed": {"tok": jnp.asarray(w)}}, cfg_j)
    t = tl.lm_logits(torch.from_numpy(x).to(torch.bfloat16),
                     {"embed": {"tok": torch.from_numpy(w)}}, cfg_t)
    assert t.dtype == torch.float32
    _close(j, t)
