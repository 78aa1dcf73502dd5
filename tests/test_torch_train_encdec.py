"""Training of the enc-dec family (whisper-medium SMOKE: 2 encoder and 2
decoder layers, 24 encoder positions) on the CPU against the reference's,
on the same weights (the JAX params through ``params_from_numpy``) and
the same batches (frames and tokens drawn with numpy from a seed):

* ``loss_fn`` and every gradient leaf against ``jax.value_and_grad`` of
  ``repro.models.model.loss_fn``, fp32 (TOL: the same fp32 arithmetic in
  another order), the encoder's attention leaves and every decoder
  cross-attention leaf nonzero, the metric keys the reference's
  ({"xent"}: its loss returns no aux);
* 5 steps of ``launch.strategy.TrainStep`` (a direct call on the CPU)
  against the reference's jitted ``make_train_step`` on bf16 frames (the
  batch ``input_specs`` gives): losses within TOL, params within
  PARAM_ATOL and 99.9% of each leaf within TOL (the dense family's
  bounds, ``test_torch_train_step.py``), the key biases, whose gradient
  is zero but for rounding, within 5 x lr (``_assert_params_close``
  says why), the metric keys equal;
* remat against no remat: the same gradients bit for bit, every block
  run twice under remat (the checkpoint recomputes it) and once without;
* ``microbatches=2`` against one batch (1e-4, the reference's lever
  bound) and against the reference's step with 2 microbatches (TOL);
* bf16 compute: the loss within 2e-2 of the reference's, every gradient
  leaf within BF16_FACTOR times the reference's own bf16 leaf's distance
  from its fp32 one;
* the orchestrator's token-only batch is refused (``ValueError``), not
  filled with zero frames.
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
from repro_torch.models import whisper as tw  # noqa: E402
from repro_torch.models.init import params_from_numpy  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402
from repro_torch.runtime.orchestrator import (Orchestrator,  # noqa: E402
                                              RunConfig)
from repro_torch.tree import flatten  # noqa: E402

ARCH = "whisper-medium"
TOL = dict(atol=1e-5, rtol=1e-5)
PARAM_ATOL = 1e-4
# the bf16 gradients against the reference's: each leaf within this
# factor of the reference's own bf16 distance from its fp32 gradient
# (the hybrid's and ssm's rule, and the factor chip_smoke.py holds the
# kernels to)
BF16_FACTOR = 2.0
B, S = 4, 16                       # rows, decoder tokens a row
LR = 1e-3


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = jsmoke(ARCH), tsmoke(ARCH)
    jparams = jmodel.init_params(jcfg, jax.random.key(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, tcfg, jparams, tparams


def _batch(cfg, seed, b=B, s=S):
    """frames (b, T, d) fp32 and tokens (b, s) int32, numpy."""
    rng = np.random.default_rng(seed)
    return {"frames": rng.standard_normal(
                (b, cfg.encoder_positions, cfg.d_model)).astype(np.float32),
            "tokens": rng.integers(0, cfg.vocab_size,
                                   (b, s)).astype(np.int32)}


def _bf16_frames(batch):
    """The batch with its frames in bf16, as ``input_specs`` gives them,
    for each framework (both round the same fp32 values to nearest)."""
    jb = {"frames": jnp.asarray(batch["frames"], dtype=jnp.bfloat16),
          "tokens": jnp.asarray(batch["tokens"])}
    tb = {"frames": torch.from_numpy(batch["frames"]).to(torch.bfloat16),
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


def _names(tree, prefix=""):
    """Dotted key paths of a tree's leaves, in ``flatten``'s order."""
    return [n for k in sorted(tree) for n in (
        _names(tree[k], f"{prefix}{k}.") if isinstance(tree[k], dict)
        else [prefix + k])]


def _assert_params_close(t_tree, j_tree, steps):
    """Trained params against the reference's: within PARAM_ATOL and 99.9%
    of each leaf within TOL (``test_torch_train_step.py``'s rule), but for
    the key biases.  A key bias shifts every score of a query's row
    alike, which the softmax does not see: its gradient is zero in exact
    arithmetic, and each side computes fp32 rounding (~1e-10, within
    TOL of the other in the gradient test).  AdamW divides that by its
    own root mean square and moves each element by up to ~lr a step,
    each side in its rounding's direction, so the key biases are held to
    ``steps`` x lr of each other."""
    for name, a, b in zip(_names(t_tree), flatten(t_tree)[0],
                          jax.tree.leaves(j_tree)):
        a = a.detach().float().numpy()
        b = np.asarray(b, dtype=np.float32)
        if name.endswith(".bk"):
            assert np.abs(a - b).max() <= steps * LR, name
            continue
        np.testing.assert_allclose(a, b, atol=PARAM_ATOL, rtol=TOL["rtol"],
                                   err_msg=name)
        outside = np.abs(a - b) > TOL["atol"] + TOL["rtol"] * np.abs(b)
        assert outside.mean() <= 1e-3, (name, int(outside.sum()), a.size)


def test_loss_fn_and_grads_match_reference(setup):
    jcfg, tcfg, jparams, tparams = setup
    batch = _batch(tcfg, 0)
    (jloss, jmet), jgrads = jax.value_and_grad(
        jmodel.loss_fn(jcfg), has_aux=True)(
        jparams, jax.tree.map(jnp.asarray, batch))
    tloss, tmet, tgrads = tstrategy.value_and_grad(tcfg)(tparams,
                                                         _tbatch(batch))
    assert float(tloss) == pytest.approx(float(jloss), rel=1e-5)
    assert set(tmet) == set(jmet) == {"xent"}
    _assert_trees_close(tgrads, jgrads, **TOL)
    for name in ("wq", "wk", "wv", "wo", "bq", "bk", "bv", "bo"):
        for tree in (tgrads["enc_blocks"]["attn"],
                     tgrads["dec_blocks"]["xattn"]):
            if name in tree:
                # every layer's slice of the stacked leaf moves
                g = tree[name].reshape(tree[name].shape[0], -1)
                assert bool((g.abs().amax(dim=1) > 0).all()), name


def _run_both(jcfg, tcfg, jparams, tparams, batches):
    """The reference's jitted step and the port's ``TrainStep`` over the
    same batches (bf16 frames) from the same params: (reference losses,
    reference state, reference metric keys, port losses, port state,
    port metric keys)."""
    jstep = jax.jit(jstrategy.make_train_step(jcfg,
                                              jadamw.AdamWConfig(lr=LR)))
    js = {"params": jparams, "opt": jadamw.adamw_init(jparams)}
    step = tstrategy.TrainStep(tcfg, tadamw.AdamWConfig(lr=LR),
                               {"params": tparams,
                                "opt": tadamw.adamw_init(tparams)},
                               B, S)
    assert step.graph.mode == "eager"
    jl, tl = [], []
    for b in batches:
        jb, tb = _bf16_frames(b)
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
    _assert_params_close(ts["params"], js["params"], 5)
    assert int(ts["opt"]["step"]) == 5
    assert tkeys == jkeys == {"loss", "xent", "grad_norm", "lr"}


def test_remat_and_no_remat_grads_bit_identical(setup, monkeypatch):
    """Every encoder and decoder block runs under the checkpoint when
    cfg.remat is set (the reference's ``jax.checkpoint``): the backward
    recomputes the same forward, the decoder's cross-attention keys and
    values included, so the gradients are those without it, bit for
    bit."""
    _, tcfg, _, tparams = setup
    assert tcfg.remat
    batch = _tbatch(_batch(tcfg, 4))
    calls = {"enc": 0, "dec": 0, "enc_kv": 0}
    real = {"enc": tw._enc_block, "dec": tw._dec_block,
            "enc_kv": tw._enc_kv}

    def counted(kind):
        def f(*args, **kwargs):
            calls[kind] += 1
            return real[kind](*args, **kwargs)
        return f

    monkeypatch.setattr(tw, "_enc_block", counted("enc"))
    monkeypatch.setattr(tw, "_dec_block", counted("dec"))
    monkeypatch.setattr(tw, "_enc_kv", counted("enc_kv"))
    out = {}
    for remat in (True, False):
        cfg = dataclasses.replace(tcfg, remat=remat)
        for k in calls:
            calls[k] = 0
        loss, _, grads = tstrategy.value_and_grad(cfg)(tparams, batch)
        n = 2 if remat else 1
        assert calls == {"enc": n * cfg.encoder_layers,
                         "dec": n * cfg.num_layers,
                         "enc_kv": n * cfg.num_layers}, (remat, calls)
        out[remat] = (loss, flatten(grads)[0])
    assert torch.equal(out[True][0], out[False][0])
    for i, (a, b) in enumerate(zip(out[True][1], out[False][1])):
        assert torch.equal(a, b), i


def test_microbatches_match_one_batch_and_reference(setup):
    """One step with ``microbatches=2`` against the port's step on the
    whole batch (the reference's lever bound, 1e-4) and against the
    reference's step with 2 microbatches (TOL), frames split with the
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
    _assert_params_close(ts["params"], js["params"], 1)
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
    too): the step refuses the batch, whose frames it would otherwise
    have to invent, with ``ValueError`` before any step runs."""
    _, tcfg, _, _ = setup
    orc = Orchestrator(tcfg, RunConfig(steps=2, batch=2, seq=8,
                                       checkpoint_every=10,
                                       ckpt_dir=str(tmp_path),
                                       device="cpu"))
    with pytest.raises(ValueError, match="frames"):
        orc.run()
    assert orc.train_step.graph.calls == 1      # the warm-up alone
