"""Training of the vlm family (llava-next-mistral-7b SMOKE: 3 layers, 8
patch embeddings before the tokens) on the CPU against the reference's,
on the same weights (the JAX params through ``params_from_numpy``) and
the same batches (patches and tokens drawn with numpy from a seed):

* ``loss_fn`` and every gradient leaf against ``jax.value_and_grad`` of
  ``repro.models.model.loss_fn``, fp32 (TOL: the same fp32 arithmetic in
  another order): the tokens after the first predicted from the stream
  positions after the patches, every attention leaf nonzero, the metric
  keys the reference's ({"xent", "aux"});
* 5 steps of ``launch.strategy.TrainStep`` (a direct call on the CPU)
  against the reference's jitted ``make_train_step`` on bf16 patches
  (the batch ``input_specs`` gives): losses within TOL, params within
  PARAM_ATOL and 99.9% of each leaf within TOL (the dense family's
  bounds, ``test_torch_train_step.py``), the metric keys equal;
* remat against no remat: the same gradients bit for bit, every block
  run twice under remat (the checkpoint recomputes it) and once without;
* ``microbatches=2`` against one batch (1e-4, the reference's lever
  bound) and against the reference's step with 2 microbatches (TOL);
* bf16 compute: the loss within 2e-2 of the reference's, every gradient
  leaf within BF16_FACTOR times the reference's own bf16 leaf's distance
  from its fp32 one;
* the orchestrator's token-only batch is refused (``ValueError``), not
  filled with zero patches.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke as jsmoke  # noqa: E402
from repro.launch import strategy as jstrategy  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro_torch.configs import get_smoke as tsmoke  # noqa: E402
from repro_torch.launch import strategy as tstrategy  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.models.init import params_from_numpy  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402
from repro_torch.runtime.orchestrator import (Orchestrator,  # noqa: E402
                                              RunConfig)
from repro_torch.tree import flatten  # noqa: E402

ARCH = "llava-next-mistral-7b"
TOL = dict(atol=1e-5, rtol=1e-5)
PARAM_ATOL = 1e-4
# the bf16 gradients against the reference's: each leaf within this
# factor of the reference's own bf16 distance from its fp32 gradient
# (the hybrid's and ssm's rule, and the factor chip_smoke.py holds the
# kernels to)
BF16_FACTOR = 2.0
B, S = 4, 16                       # rows, tokens a row after the patches
LR = 1e-3


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = jsmoke(ARCH), tsmoke(ARCH)
    jparams = jmodel.init_params(jcfg, jax.random.key(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, tcfg, jparams, tparams


def _batch(cfg, seed, b=B, s=S):
    """patches (b, p, d) fp32 and tokens (b, s) int32, numpy."""
    rng = np.random.default_rng(seed)
    return {"patches": rng.standard_normal(
                (b, cfg.num_patches, cfg.d_model)).astype(np.float32),
            "tokens": rng.integers(0, cfg.vocab_size,
                                   (b, s)).astype(np.int32)}


def _bf16_patches(batch):
    """The batch with its patches in bf16, as ``input_specs`` gives them,
    for each framework (both round the same fp32 values to nearest)."""
    jb = {"patches": jnp.asarray(batch["patches"], dtype=jnp.bfloat16),
          "tokens": jnp.asarray(batch["tokens"])}
    tb = {"patches": torch.from_numpy(batch["patches"]).to(torch.bfloat16),
          "tokens": torch.from_numpy(batch["tokens"])}
    return jb, tb


def _tbatch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _assert_trees_close(t_tree, j_tree, **tol):
    t, j = flatten(t_tree)[0], jax.tree.leaves(j_tree)
    assert len(t) == len(j)
    for i, (a, b) in enumerate(zip(t, j)):
        np.testing.assert_allclose(a.detach().float().numpy(),
                                   np.asarray(b, dtype=np.float32),
                                   err_msg=f"leaf {i}", **tol)


def _assert_params_close(t_tree, j_tree):
    """Trained params against the reference's: within PARAM_ATOL and 99.9%
    of each leaf within TOL (``test_torch_train_step.py``'s rule)."""
    _assert_trees_close(t_tree, j_tree, atol=PARAM_ATOL, rtol=TOL["rtol"])
    for i, (a, b) in enumerate(zip(flatten(t_tree)[0],
                                   jax.tree.leaves(j_tree))):
        a = a.detach().float().numpy()
        b = np.asarray(b, dtype=np.float32)
        outside = np.abs(a - b) > TOL["atol"] + TOL["rtol"] * np.abs(b)
        assert outside.mean() <= 1e-3, (i, int(outside.sum()), a.size)


def test_loss_fn_and_grads_match_reference(setup):
    jcfg, tcfg, jparams, tparams = setup
    batch = _batch(tcfg, 0)
    (jloss, jmet), jgrads = jax.value_and_grad(
        jmodel.loss_fn(jcfg), has_aux=True)(
        jparams, jax.tree.map(jnp.asarray, batch))
    tloss, tmet, tgrads = tstrategy.value_and_grad(tcfg)(tparams,
                                                         _tbatch(batch))
    assert float(tloss) == pytest.approx(float(jloss), rel=1e-5)
    assert set(tmet) == set(jmet) == {"xent", "aux"}
    _assert_trees_close(tgrads, jgrads, **TOL)
    for name in ("wq", "wk", "wv", "wo"):
        # every layer's slice of the stacked leaf moves
        g = tgrads["blocks"]["attn"][name]
        g = g.reshape(g.shape[0], -1)
        assert bool((g.abs().amax(dim=1) > 0).all()), name


def _run_both(jcfg, tcfg, jparams, tparams, batches):
    """The reference's jitted step and the port's ``TrainStep`` over the
    same batches (bf16 patches) from the same params: (reference losses,
    reference state, reference metric keys, port losses, port state,
    port metric keys)."""
    jstep = jax.jit(jstrategy.make_train_step(jcfg,
                                              jadamw.AdamWConfig(lr=LR)))
    js = {"params": jparams, "opt": jadamw.adamw_init(jparams)}
    step = tstrategy.TrainStep(tcfg, tadamw.AdamWConfig(lr=LR),
                               {"params": tparams,
                                "opt": tadamw.adamw_init(tparams)},
                               B, tcfg.num_patches + S)
    assert step.graph.mode == "eager"
    jl, tl = [], []
    for b in batches:
        jb, tb = _bf16_patches(b)
        js, jm = jstep(js, jb)
        tm = step(tb)
        jl.append(float(jm["loss"]))
        tl.append(float(tm["loss"]))
    return jl, js, set(jm), tl, step.state, set(tm)


def test_five_train_steps_match_reference(setup):
    jcfg, tcfg, jparams, tparams = setup
    jl, js, jkeys, tl, ts, tkeys = _run_both(
        jcfg, tcfg, jparams, tparams, [_batch(tcfg, 10 + i)
                                       for i in range(5)])
    np.testing.assert_allclose(tl, jl, **TOL)
    _assert_params_close(ts["params"], js["params"])
    assert int(ts["opt"]["step"]) == 5
    assert tkeys == jkeys == {"loss", "xent", "aux", "grad_norm", "lr"}


def test_remat_and_no_remat_grads_bit_identical(setup, monkeypatch):
    """Every block runs under the checkpoint when cfg.remat is set (the
    reference's ``jax.checkpoint``): the backward recomputes the same
    forward, so the gradients are those without it, bit for bit."""
    _, tcfg, _, tparams = setup
    assert tcfg.remat
    batch = _tbatch(_batch(tcfg, 4))
    calls = []
    real = ttf.decoder_block

    def counted(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(ttf, "decoder_block", counted)
    out = {}
    for remat in (True, False):
        cfg = dataclasses.replace(tcfg, remat=remat)
        calls.clear()
        loss, _, grads = tstrategy.value_and_grad(cfg)(tparams, batch)
        assert len(calls) == cfg.num_layers * (2 if remat else 1), remat
        out[remat] = (loss, flatten(grads)[0])
    assert torch.equal(out[True][0], out[False][0])
    for i, (a, b) in enumerate(zip(out[True][1], out[False][1])):
        assert torch.equal(a, b), i


def test_microbatches_match_one_batch_and_reference(setup):
    """One step with ``microbatches=2`` against the port's step on the
    whole batch (the reference's lever bound, 1e-4) and against the
    reference's step with 2 microbatches (TOL), patches split with the
    tokens."""
    jcfg, tcfg, jparams, tparams = setup
    batches = [_batch(tcfg, 20)]
    _, _, _, base_l, base_s, _ = _run_both(jcfg, tcfg, jparams, tparams,
                                           batches)
    jl, js, jkeys, tl, ts, tkeys = _run_both(
        dataclasses.replace(jcfg, microbatches=2),
        dataclasses.replace(tcfg, microbatches=2), jparams, tparams,
        batches)
    assert abs(tl[0] - base_l[0]) < 1e-4
    dp = max(float((a - b).abs().max()) for a, b in
             zip(flatten(ts["params"])[0], flatten(base_s["params"])[0]))
    assert dp < 1e-4
    np.testing.assert_allclose(tl, jl, **TOL)
    _assert_params_close(ts["params"], js["params"])
    assert tkeys == jkeys == {"loss", "grad_norm", "lr"}


def test_bf16_compute_loss_and_grads_near_reference(setup):
    """The reference's mixed precision (bf16 copies of the 2-D params)
    on both sides: the loss within 2e-2, each gradient leaf within
    BF16_FACTOR times the reference's bf16 leaf's distance from its fp32
    leaf, on the same batch."""
    jcfg, tcfg, jparams, tparams = setup
    jcfg16 = dataclasses.replace(jcfg, compute_dtype=jnp.bfloat16)
    tcfg16 = dataclasses.replace(tcfg, compute_dtype=torch.bfloat16)
    batch = _batch(tcfg, 3)
    jb = jax.tree.map(jnp.asarray, batch)

    def cast(p):
        return p.astype(jnp.bfloat16) if p.ndim > 1 else p

    (jloss, _), jgrads = jax.value_and_grad(
        jmodel.loss_fn(jcfg16), has_aux=True)(
        jax.tree.map(cast, jparams), jb)
    _, jgrads32 = jax.value_and_grad(jmodel.loss_fn(jcfg), has_aux=True)(
        jparams, jb)
    tloss, _, tgrads = tstrategy.value_and_grad(tcfg16)(tparams,
                                                        _tbatch(batch))
    assert abs(float(tloss) - float(jloss)) < 2e-2
    for i, (a, b, c) in enumerate(zip(flatten(tgrads)[0],
                                      jax.tree.leaves(jgrads),
                                      jax.tree.leaves(jgrads32))):
        assert a.dtype == (torch.bfloat16 if b.ndim > 1 else torch.float32)
        a = a.float().numpy()
        b, c = (np.asarray(t, dtype=np.float32) for t in (b, c))
        rel = np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12)
        own = np.linalg.norm(b - c) / max(np.linalg.norm(c), 1e-12)
        assert rel <= BF16_FACTOR * own, (i, a.shape, rel, own)


def test_orchestrator_token_only_batch_is_refused(setup, tmp_path):
    """The orchestrator's pipeline yields tokens only (the reference's
    too): the step refuses the batch, whose patches it would otherwise
    have to invent, with ``ValueError`` before any step runs."""
    _, tcfg, _, _ = setup
    orc = Orchestrator(tcfg, RunConfig(steps=2, batch=2,
                                       seq=tcfg.num_patches + 8,
                                       checkpoint_every=10,
                                       ckpt_dir=str(tmp_path),
                                       device="cpu"))
    with pytest.raises(ValueError, match="patches"):
        orc.run()
    assert orc.train_step.graph.calls == 1      # the warm-up alone
