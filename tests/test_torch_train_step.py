"""The port's training path against the reference's on the CPU, on the
same weights (the JAX params through ``params_from_numpy``) and the same
batches (the reference's ``DataPipeline``), SMOKE smollm-135m:

* ``softmax_xent``, ``loss_fn`` and its gradients against the reference's
  and ``jax.grad``, fp32 (tolerance 1e-5: the same fp32 arithmetic in
  another order; gradients 1e-5 absolute and relative);
* ``adamw_apply`` with and without a schedule against the reference's on
  random trees (1e-6: elementwise fp32 arithmetic, only ``pow`` and the
  global norm's sum may differ in the last bit), and the schedules;
* 5 steps of ``make_train_step`` against the reference's jitted
  ``make_train_step``: losses within 1e-5; final params within 1e-5
  (absolute and relative) for 99.9% of each leaf's elements and within
  1e-4 for all.  AdamW moves each element by about lr x m / sqrt(v),
  whatever the gradient's size, so an element whose gradient is tiny
  (near 0 after the 2-norm clip) carries that gradient's fp32 rounding
  as a relative error of its whole step: up to 5 x lr = 5e-3 over 5
  steps, of which the CPU's thread-dependent summation order leaves a
  few elements 1e-5..2e-5 apart;
* the ``loss_chunk`` / ``microbatches`` equivalences of the reference's
  ``tests/test_system.py`` (1e-4, its bound), each also against the
  reference step with the same setting;
* a bf16-compute SMOKE variant: loss within 2e-2 and every gradient leaf,
  embedding and tied head included, within 5% of the reference leaf's
  norm (bf16 keeps ~3 significant digits and the two frameworks round
  the activations and the embedding's scatter-add sums at other places:
  the leaves land 1.7-2.5% apart);
* ``input_specs`` / ``synthetic_batch`` / ``abstract_train_state`` shapes
  and dtypes; ``model.loss_fn`` sends the enc-dec family to
  ``whisper.loss_fn`` and every other to ``transformer.loss_fn``, and
  refuses a family the reference does not know (``ValueError``);
* the MoE family, deepseek-moe-16b and mixtral-8x7b SMOKE, through the
  same checks: ``loss_fn`` (xent, the load-balancing aux summed over the
  MoE layers, and ``0.01 * aux`` in the loss) and its gradients within
  TOL, 5 steps of ``make_train_step`` with the dense tolerances, and the
  bf16 variant within 5% of each leaf's norm.  The fp32 checks first
  assert the first step's routing (every MoE layer's expert ids, from
  the reference run eagerly without remat) equal on both sides, so a
  near-tie between two experts would show as such and not as a loose
  gradient.  In bf16 the frameworks' other rounding tips near-ties, so
  the port's routing is held to the reference's up to near-ties (2^-4
  relative) and then pinned to the reference's ids for the gradients
  (the test's note says why);
* the hybrid family, recurrentgemma-2b SMOKE (RG-LRU layers and windowed
  MQA attention, window 16 under 32-token sequences), through the same
  checks: ``loss_fn`` and its gradients within TOL (every ``lru_*``,
  ``w_y`` and ``conv_*`` leaf nonzero), 5 steps of ``make_train_step``
  with the dense tolerances, the bf16 variant against the reference's
  own bf16 rounding (``HYBRID_BF16_FACTOR``), and the port's gradients
  with and without remat bit-identical (the checkpoint recomputes the
  same forward);
* the ssm family, rwkv6-3b SMOKE (3 RWKV-6 blocks, 4 WKV heads of 16),
  through the hybrid's checks: ``loss_fn`` and its gradients
  (``SSM_GRAD_SHARE``: the first token's group norm multiplies fp32
  rounding, on both sides), every leaf whose gradient comes through the
  WKV's reverse nonzero, 5 steps of ``make_train_step`` (losses and each
  leaf's update, ``SSM_LOSS_ATOL`` / ``SSM_UPDATE_RTOL``), the bf16
  variant against the reference's own bf16 rounding
  (``SSM_BF16_FACTOR``), and remat against no remat bit for bit, with
  the WKV called twice a layer under remat and once without.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke as jsmoke  # noqa: E402
from repro.data.pipeline import DataPipeline as JaxPipeline  # noqa: E402
from repro.launch import strategy as jstrategy  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models.config import ShapeConfig as JShape  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim import schedules as jsched  # noqa: E402
from repro_torch.configs import get_smoke as tsmoke  # noqa: E402
from repro_torch.launch import strategy as tstrategy  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import rglru as trglru  # noqa: E402
from repro_torch.models import rwkv as trwkv  # noqa: E402
from repro_torch.models.config import ShapeConfig  # noqa: E402
from repro_torch.models.init import params_from_numpy  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402
from repro_torch.optim import schedules as tsched  # noqa: E402
from repro_torch.tree import flatten  # noqa: E402

ARCH = "smollm-135m"
TOL = dict(atol=1e-5, rtol=1e-5)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _leaves(tree):
    """Leaves of a nested dict in sorted-key order (both packages)."""
    return flatten(tree)[0]


def _assert_trees_close(t_tree, j_tree, **tol):
    t, j = _leaves(t_tree), jax.tree.leaves(j_tree)
    assert len(t) == len(j)
    for i, (a, b) in enumerate(zip(t, j)):
        np.testing.assert_allclose(a.detach().float().numpy(),
                                   np.asarray(b, dtype=np.float32),
                                   err_msg=f"leaf {i}", **tol)


# trained params against the reference's (the module note): all within
# PARAM_ATOL, and 99.9% of each leaf's elements within TOL
PARAM_ATOL = 1e-4


def _assert_params_close(t_tree, j_tree):
    _assert_trees_close(t_tree, j_tree, atol=PARAM_ATOL, rtol=TOL["rtol"])
    for i, (a, b) in enumerate(zip(_leaves(t_tree),
                                   jax.tree.leaves(j_tree))):
        a = a.detach().float().numpy()
        b = np.asarray(b, dtype=np.float32)
        outside = np.abs(a - b) > TOL["atol"] + TOL["rtol"] * np.abs(b)
        assert outside.mean() <= 1e-3, (i, int(outside.sum()), a.size)


def _batches(cfg, n, batch=4, seq=32, seed=0):
    pipe = JaxPipeline(cfg.vocab_size, batch, seq, seed=seed)
    return [next(pipe) for _ in range(n)]


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = jsmoke(ARCH), tsmoke(ARCH)
    jparams = jmodel.init_params(jcfg, jax.random.key(0))
    tparams = params_from_numpy(_np_tree(jparams), device="cpu")
    return jcfg, tcfg, jparams, tparams


def _tbatch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def test_softmax_xent_matches_reference():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((3, 7, 50)).astype(np.float32) * 4
    labels = rng.integers(0, 50, (3, 7)).astype(np.int32)
    want = float(jlayers.softmax_xent(jnp.asarray(logits),
                                      jnp.asarray(labels)))
    got = float(tlayers.softmax_xent(torch.from_numpy(logits),
                                     torch.from_numpy(labels)))
    assert got == pytest.approx(want, rel=1e-6, abs=1e-6)


def test_loss_fn_and_grads_match_reference(setup):
    jcfg, tcfg, jparams, tparams = setup
    batch = _batches(jcfg, 1)[0]
    jlfn = jmodel.loss_fn(jcfg)
    (jloss, jmet), jgrads = jax.value_and_grad(jlfn, has_aux=True)(
        jparams, jax.tree.map(jnp.asarray, batch))
    tloss, tmet, tgrads = tstrategy.value_and_grad(tcfg)(tparams,
                                                         _tbatch(batch))
    assert float(tloss) == pytest.approx(float(jloss), **{"rel": 1e-5})
    assert set(tmet) == set(jmet) == {"xent", "aux"}
    assert float(tmet["aux"]) == 0.0
    _assert_trees_close(tgrads, jgrads, **TOL)


def _random_tree(rng, scale=1.0):
    return {"a": {"w": rng.standard_normal((6, 5)).astype(np.float32)
                  * scale,
                  "b": rng.standard_normal((5,)).astype(np.float32) * scale},
            "emb": rng.standard_normal((9, 4)).astype(np.float32) * scale}


@pytest.mark.parametrize("schedule", ["none", "wsd", "cosine"])
@pytest.mark.parametrize("clip", [1.0, 0.0])
def test_adamw_apply_matches_reference(schedule, clip):
    rng = np.random.default_rng(1)
    params = _random_tree(rng)
    scheds = {"none": (None, None),
              "wsd": (jsched.wsd_schedule(1e-3, 2, 1, 3, 1e-4),
                      tsched.wsd_schedule(1e-3, 2, 1, 3, 1e-4)),
              "cosine": (jsched.cosine_schedule(1e-3, 2, 6, 1e-5),
                         tsched.cosine_schedule(1e-3, 2, 6, 1e-5))}
    jsc, tsc = scheds[schedule]
    jcfg = jadamw.AdamWConfig(lr=2e-3, grad_clip=clip, schedule=jsc)
    tcfg = tadamw.AdamWConfig(lr=2e-3, grad_clip=clip, schedule=tsc)
    jp = jax.tree.map(jnp.asarray, params)
    tp = jax.tree.map(torch.from_numpy, params)
    jo, to = jadamw.adamw_init(jp), tadamw.adamw_init(tp)
    for _ in range(6):
        grads = _random_tree(rng, scale=3.0)
        jp, jo, jm = jadamw.adamw_apply(jax.tree.map(jnp.asarray, grads), jo,
                                        jp, jcfg)
        tp, to, tm = tadamw.adamw_apply(jax.tree.map(torch.from_numpy,
                                                     grads), to, tp, tcfg)
        for key in ("grad_norm", "lr"):
            assert float(tm[key]) == pytest.approx(float(jm[key]), rel=1e-6)
    _assert_trees_close(tp, jp, atol=1e-6, rtol=1e-6)
    _assert_trees_close(to["m"], jo["m"], atol=1e-6, rtol=1e-6)
    _assert_trees_close(to["v"], jo["v"], atol=1e-6, rtol=1e-6)
    assert to["step"].dtype == torch.int32 and int(to["step"]) == 6


@pytest.mark.parametrize("name", ["wsd", "cosine"])
def test_schedules_match_reference(name):
    steps = np.arange(0, 30, dtype=np.int32)
    if name == "wsd":
        j, t = (m.wsd_schedule(3e-4, 5, 10, 8, 1e-5)
                for m in (jsched, tsched))
    else:
        j, t = (m.cosine_schedule(3e-4, 5, 25, 1e-5)
                for m in (jsched, tsched))
    np.testing.assert_allclose(t(torch.from_numpy(steps)).numpy(),
                               np.asarray(j(jnp.asarray(steps))),
                               rtol=1e-6, atol=1e-12)


def _run_steps(jcfg, tcfg, jparams, tparams, batches):
    """Both train steps (AdamW at lr 1e-3) over ``batches`` from the same
    params: (jax losses, jax state, port losses, port state)."""
    jstep = jax.jit(jstrategy.make_train_step(jcfg,
                                              jadamw.AdamWConfig(lr=1e-3)))
    tstep = tstrategy.make_train_step(tcfg, tadamw.AdamWConfig(lr=1e-3))
    js = {"params": jparams, "opt": jadamw.adamw_init(jparams)}
    ts = {"params": tparams, "opt": tadamw.adamw_init(tparams)}
    jl, tl = [], []
    for b in batches:
        js, jm = jstep(js, jax.tree.map(jnp.asarray, b))
        ts, tm = tstep(ts, _tbatch(b))
        jl.append(float(jm["loss"]))
        tl.append(float(tm["loss"]))
    return jl, js, tl, ts


@pytest.fixture(scope="module")
def five_steps(setup):
    jcfg, tcfg, jparams, tparams = setup
    return _run_steps(jcfg, tcfg, jparams, tparams, _batches(jcfg, 5))


def test_five_train_steps_match_reference(five_steps):
    jl, js, tl, ts = five_steps
    np.testing.assert_allclose(tl, jl, **TOL)
    _assert_params_close(ts["params"], js["params"])
    assert int(ts["opt"]["step"]) == 5


def test_train_step_casts_like_the_reference():
    """bf16 compute: the gradients the optimizer gets are bf16 for every
    parameter with more than one dim (and fp32 for the norms), the master
    params stay fp32."""
    cfg = dataclasses.replace(tsmoke(ARCH), compute_dtype=torch.bfloat16)
    state = tstrategy.init_train_state(cfg, torch.Generator().manual_seed(0),
                                       device="cpu")
    batch = _tbatch(_batches(cfg, 1)[0])
    _, _, grads = tstrategy.value_and_grad(cfg)(state["params"], batch)
    for p, g in zip(_leaves(state["params"]), _leaves(grads)):
        assert p.dtype == torch.float32
        assert g.dtype == (torch.bfloat16 if p.dim() > 1 else torch.float32)
    new, metrics = tstrategy.make_train_step(cfg, tadamw.AdamWConfig())(
        state, batch)
    assert all(p.dtype == torch.float32 for p in _leaves(new["params"]))
    assert set(metrics) == {"loss", "xent", "aux", "grad_norm", "lr"}


@pytest.mark.parametrize("kw", [dict(loss_chunk=16), dict(microbatches=4),
                                dict(loss_chunk=16, microbatches=2)],
                         ids=["chunk16", "mb4", "chunk16-mb2"])
def test_loss_chunk_and_microbatch_equivalence(setup, kw):
    """The reference's lever equivalences (``tests/test_system.py``) on
    the port: one step with each lever against the port's plain step
    within 1e-4, and against the reference's step with the same lever:
    loss within 1e-5, params as ``_assert_params_close``."""
    jcfg0, tcfg0, jparams, tparams = setup
    toks = np.random.default_rng(1).integers(
        0, jcfg0.vocab_size, (8, 64)).astype(np.int32)
    batches = [{"tokens": toks}]
    _, _, base_l, base_s = _run_steps(jcfg0, tcfg0, jparams, tparams,
                                      batches)
    jl, js, tl, ts = _run_steps(dataclasses.replace(jcfg0, **kw),
                                dataclasses.replace(tcfg0, **kw), jparams,
                                tparams, batches)
    assert abs(tl[0] - base_l[0]) < 1e-4
    dp = max(float((a - b).abs().max()) for a, b in
             zip(_leaves(ts["params"]), _leaves(base_s["params"])))
    assert dp < 1e-4
    np.testing.assert_allclose(tl, jl, **TOL)
    _assert_params_close(ts["params"], js["params"])


def test_bf16_compute_loss_and_grads_near_reference(setup):
    """The reference's mixed precision (bf16 copies of the 2-D params)
    on both sides: the embedding gradient (an indexed gather's
    scatter-add) and the tied head's (through ``lm_logits``) included."""
    jcfg, tcfg, jparams, tparams = setup
    jcfg = dataclasses.replace(jcfg, compute_dtype=jnp.bfloat16)
    tcfg = dataclasses.replace(tcfg, compute_dtype=torch.bfloat16)
    batch = _batches(jcfg, 1, seed=3)[0]

    def cast(p):
        return p.astype(jnp.bfloat16) if p.ndim > 1 else p

    jlfn = jmodel.loss_fn(jcfg)
    (jloss, _), jgrads = jax.value_and_grad(jlfn, has_aux=True)(
        jax.tree.map(cast, jparams), jax.tree.map(jnp.asarray, batch))
    tloss, _, tgrads = tstrategy.value_and_grad(tcfg)(tparams,
                                                      _tbatch(batch))
    assert abs(float(tloss) - float(jloss)) < 2e-2
    t, j = _leaves(tgrads), jax.tree.leaves(jgrads)
    for i, (a, b) in enumerate(zip(t, j)):
        assert a.dtype == (torch.bfloat16 if b.ndim > 1 else torch.float32)
        a = a.float().numpy()
        b = np.asarray(b, dtype=np.float32)
        rel = np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12)
        print(i, a.shape, rel)
        assert rel < 0.05, (i, a.shape, rel)
    emb_t = tgrads["embed"]["tok"].float().numpy()
    emb_j = np.asarray(jgrads["embed"]["tok"], dtype=np.float32)
    assert np.linalg.norm(emb_t - emb_j) < 0.05 * np.linalg.norm(emb_j)


def test_input_specs_and_synthetic_batch(setup):
    jcfg, tcfg, _, _ = setup
    for kind, seq, b in (("train", 64, 4), ("prefill", 32, 2),
                         ("decode", 48, 3)):
        jspec = jmodel.input_specs(jcfg, JShape("x", kind, seq, b))
        tspec = tmodel.input_specs(tcfg, ShapeConfig("x", kind, seq, b))
        jl = jax.tree.leaves(jspec)
        tl = _leaves(tspec)
        assert [tuple(x.shape) for x in tl] == [x.shape for x in jl]
        assert [str(x.dtype).split(".")[-1] for x in tl] == \
            [np.dtype(x.dtype).name for x in jl]
        assert all(x.device.type == "meta" for x in tl)
        batch = tmodel.synthetic_batch(tcfg, ShapeConfig("x", kind, seq, b),
                                       torch.Generator().manual_seed(1))
        for x in _leaves(batch):
            assert x.device.type == "cpu"
            if not x.dtype.is_floating_point:
                assert int(x.min()) >= 0 and int(x.max()) < tcfg.vocab_size
    assert ShapeConfig("t", "train", 64, 4).tokens == 256


def test_abstract_train_state_matches_reference(setup):
    jcfg, tcfg, _, _ = setup
    j = jax.tree.leaves(jstrategy.abstract_train_state(jcfg))
    t = _leaves(tstrategy.abstract_train_state(tcfg))
    assert [tuple(x.shape) for x in t] == [x.shape for x in j]
    assert [str(x.dtype).split(".")[-1] for x in t] == \
        [np.dtype(x.dtype).name for x in j]


@pytest.mark.parametrize("arch", ["smollm-135m", "deepseek-moe-16b",
                                  "recurrentgemma-2b", "rwkv6-3b",
                                  "whisper-medium", "llava-next-mistral-7b"])
def test_loss_fn_dispatches_by_family(arch, monkeypatch):
    """``model.loss_fn`` sends the enc-dec family to ``whisper.loss_fn``
    and every other family to ``transformer.loss_fn`` (the reference's
    dispatch), with the implementations it was given."""
    from repro_torch.models import transformer, whisper

    cfg = tsmoke(arch)
    seen = []
    monkeypatch.setattr(whisper, "loss_fn", lambda p, b, c, **kw:
                        seen.append(("whisper", c, kw)))
    monkeypatch.setattr(transformer, "loss_fn", lambda p, b, c, **kw:
                        seen.append(("transformer", c, kw)))
    tmodel.loss_fn(cfg, attn_impl="ref")({}, {})
    want = ("whisper" if cfg.family == "encdec" else "transformer")
    assert [(w, c) for w, c, _ in seen] == [(want, cfg)]
    assert seen[0][2]["attn_impl"] == "ref"


def test_untrained_families_are_refused():
    """A family the reference does not know (smollm's SMOKE config
    relabelled) is refused when the loss is made, before any call."""
    cfg = dataclasses.replace(tsmoke(ARCH), family="diffusion")
    with pytest.raises(ValueError, match="unknown model family"):
        tmodel.loss_fn(cfg)


# ---------------------------------------------------------------------------
# the MoE family
# ---------------------------------------------------------------------------

MOE_ARCHS = ["deepseek-moe-16b", "mixtral-8x7b"]


@pytest.fixture(scope="module", params=MOE_ARCHS)
def moe_setup(request):
    jcfg, tcfg = jsmoke(request.param), tsmoke(request.param)
    jparams = jmodel.init_params(jcfg, jax.random.key(0))
    tparams = params_from_numpy(_np_tree(jparams), device="cpu")
    return jcfg, tcfg, jparams, tparams


def _assert_same_routing(jcfg, tcfg, jparams, tparams, batch, monkeypatch):
    """Every MoE layer's expert ids in one forward, both sides equal: the
    reference's loss run eagerly (without remat, which traces even then)
    and the port's, each ``router_topk`` recording its ids."""
    seen = {"jax": [], "torch": []}
    jreal, treal = jmoe.router_topk, tmoe.router_topk

    def jspy(x2d, w, cfg):
        out = jreal(x2d, w, cfg)
        seen["jax"].append(np.asarray(out[1]))
        return out

    def tspy(x2d, w, cfg):
        out = treal(x2d, w, cfg)
        seen["torch"].append(out[1].numpy())
        return out

    with monkeypatch.context() as m:
        m.setattr(jmoe, "router_topk", jspy)
        m.setattr(tmoe, "router_topk", tspy)
        with jax.disable_jit():
            jmodel.loss_fn(dataclasses.replace(jcfg, remat=False))(
                jparams, jax.tree.map(jnp.asarray, batch))
        with torch.no_grad():
            tmodel.loss_fn(tcfg)(tparams, _tbatch(batch))
    n_moe = tcfg.num_layers - tcfg.first_k_dense
    assert len(seen["jax"]) == len(seen["torch"]) == n_moe
    for i, (j, t) in enumerate(zip(seen["jax"], seen["torch"])):
        np.testing.assert_array_equal(t, j, err_msg=f"routing, MoE layer {i}")


def test_moe_loss_fn_and_grads_match_reference(moe_setup, monkeypatch):
    jcfg, tcfg, jparams, tparams = moe_setup
    batch = _batches(jcfg, 1)[0]
    _assert_same_routing(jcfg, tcfg, jparams, tparams, batch, monkeypatch)
    (jloss, jmet), jgrads = jax.value_and_grad(
        jmodel.loss_fn(jcfg), has_aux=True)(
        jparams, jax.tree.map(jnp.asarray, batch))
    tloss, tmet, tgrads = tstrategy.value_and_grad(tcfg)(tparams,
                                                         _tbatch(batch))
    assert set(tmet) == set(jmet) == {"xent", "aux"}
    for k in ("xent", "aux"):
        assert float(tmet[k]) == pytest.approx(float(jmet[k]), rel=1e-5)
    assert float(tmet["aux"]) > 0
    assert float(tloss) == pytest.approx(float(jloss), rel=1e-5)
    assert float(tloss) == pytest.approx(
        float(tmet["xent"]) + 0.01 * float(tmet["aux"]), rel=1e-6)
    _assert_trees_close(tgrads, jgrads, **TOL)


def test_moe_five_train_steps_match_reference(moe_setup, monkeypatch):
    jcfg, tcfg, jparams, tparams = moe_setup
    batches = _batches(jcfg, 5)
    _assert_same_routing(jcfg, tcfg, jparams, tparams, batches[0],
                         monkeypatch)
    jl, js, tl, ts = _run_steps(jcfg, tcfg, jparams, tparams, batches)
    np.testing.assert_allclose(tl, jl, **TOL)
    _assert_params_close(ts["params"], js["params"])
    assert int(ts["opt"]["step"]) == 5


def _reference_routing(jcfg, batch_fn, monkeypatch):
    """Run ``batch_fn()`` (the reference's loss or its gradient) with its
    ``router_topk`` reporting each MoE layer's expert ids from inside
    the traced computation (``jax.debug.callback``: the ids the run
    itself used, bf16 fusion included).  Under remat each layer reports
    twice, forward and recompute, with the same ids.  Returns
    (batch_fn's result, [ids per MoE layer])."""
    seen = []
    real = jmoe.router_topk

    def spy(x2d, w, cfg):
        out = real(x2d, w, cfg)
        jax.debug.callback(lambda i: seen.append(np.array(i)), out[1])
        return out

    with monkeypatch.context() as m:
        m.setattr(jmoe, "router_topk", spy)
        result = batch_fn()
    n_moe = jcfg.num_layers - jcfg.first_k_dense
    assert len(seen) == 2 * n_moe
    for a, b in zip(seen[:n_moe], seen[2 * n_moe - 1:n_moe - 1:-1]):
        np.testing.assert_array_equal(a, b)
    return result, seen[:n_moe]


def _pinned_router(ids, gaps):
    """The port's ``router_topk`` with its expert ids replaced by
    ``ids[layer]`` (a layer known by its router weight's address, in the
    order first seen) and its gates and aux loss taken at those ids, as
    the port's router computes them; records in ``gaps``, for each layer,
    the largest relative gap between the probabilities of the port's own
    choice and the pinned one at a rank where they differ."""
    real = tmoe.router_topk
    layer_of = {}

    def router(x2d, router_w, cfg):
        layer = layer_of.setdefault(router_w.data_ptr(), len(layer_of))
        _, own, _ = real(x2d, router_w, cfg)
        idx = torch.from_numpy(ids[layer]).long()
        probs = torch.softmax(x2d.float() @ router_w.float(), dim=-1)
        with torch.no_grad():
            pa, pb = probs.gather(1, own), probs.gather(1, idx)
            gap = ((pa - pb).abs() / pa).max().item()
            gaps[layer] = max(gaps.get(layer, 0.0), gap)
        gates = probs.gather(1, idx)
        if cfg.router_renormalize:
            gates = gates / (gates.sum(dim=-1, keepdim=True) + 1e-9)
        me = torch.nn.functional.one_hot(idx[:, 0], cfg.num_experts)
        aux = cfg.num_experts * torch.sum(me.float().mean(dim=0)
                                          * probs.mean(dim=0))
        return gates, idx, aux

    return router


# in bf16 the two frameworks round the router's inputs at other places
# (by ~2^-8 per element, compounded through the layers below), which
# moves a token's expert probabilities by up to ~2% relative (measured on
# these configs): two experts closer than NEAR_TIE may swap
NEAR_TIE = 2.0 ** -4


def test_moe_bf16_compute_grads_near_reference(moe_setup, monkeypatch):
    """The bf16 variant, as the dense one: the reference's mixed
    precision on both sides, loss within 2e-2 and every gradient leaf
    within 5% of the reference leaf's norm.  Where bf16 rounding tips a
    near-tie the two sides route a token differently, a discrete change
    that moves an expert's gradient by that token's whole share (the
    reference's own bf16 gradients lie 3-30% from its fp32 ones on
    these configs).  So the port's routing is first held to the
    reference's up to near-ties (every differing choice within NEAR_TIE
    of the reference's choice), then pinned to the reference's ids for
    the gradient comparison, which then measures the arithmetic alone."""
    jcfg, tcfg, jparams, tparams = moe_setup
    jcfg = dataclasses.replace(jcfg, compute_dtype=jnp.bfloat16)
    tcfg = dataclasses.replace(tcfg, compute_dtype=torch.bfloat16)
    batch = _batches(jcfg, 1, seed=3)[0]

    def cast(p):
        return p.astype(jnp.bfloat16) if p.ndim > 1 else p

    ((jloss, _), jgrads), ids = _reference_routing(
        jcfg, lambda: jax.value_and_grad(jmodel.loss_fn(jcfg), has_aux=True)(
            jax.tree.map(cast, jparams), jax.tree.map(jnp.asarray, batch)),
        monkeypatch)
    gaps = {}
    monkeypatch.setattr(tmoe, "router_topk", _pinned_router(ids, gaps))
    tloss, _, tgrads = tstrategy.value_and_grad(tcfg)(tparams,
                                                      _tbatch(batch))
    assert len(gaps) == len(ids)
    assert max(gaps.values()) <= NEAR_TIE, gaps
    assert abs(float(tloss) - float(jloss)) < 2e-2
    for i, (a, b) in enumerate(zip(_leaves(tgrads), jax.tree.leaves(jgrads))):
        assert a.dtype == (torch.bfloat16 if b.ndim > 1 else torch.float32)
        a = a.float().numpy()
        b = np.asarray(b, dtype=np.float32)
        rel = np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12)
        assert rel < 0.05, (i, a.shape, rel)


# ---------------------------------------------------------------------------
# the hybrid family
# ---------------------------------------------------------------------------

HYBRID = "recurrentgemma-2b"
# the recurrent layers' leaves, whose gradients come through the RG-LRU
# scan's reverse (the value branch) alone
SCAN_LEAVES = ("lru_wa", "lru_ba", "lru_wx", "lru_bx", "lru_a", "w_y",
               "conv_w", "conv_b")


@pytest.fixture(scope="module")
def hybrid_setup():
    jcfg, tcfg = jsmoke(HYBRID), tsmoke(HYBRID)
    jparams = jmodel.init_params(jcfg, jax.random.key(0))
    tparams = params_from_numpy(_np_tree(jparams), device="cpu")
    return jcfg, tcfg, jparams, tparams


def test_hybrid_loss_fn_and_grads_match_reference(hybrid_setup):
    jcfg, tcfg, jparams, tparams = hybrid_setup
    batch = _batches(jcfg, 1)[0]
    (jloss, jmet), jgrads = jax.value_and_grad(
        jmodel.loss_fn(jcfg), has_aux=True)(
        jparams, jax.tree.map(jnp.asarray, batch))
    tloss, tmet, tgrads = tstrategy.value_and_grad(tcfg)(tparams,
                                                         _tbatch(batch))
    assert float(tloss) == pytest.approx(float(jloss), rel=1e-5)
    assert set(tmet) == set(jmet) == {"xent", "aux"}
    _assert_trees_close(tgrads, jgrads, **TOL)
    rec = [i for i in range(tcfg.num_layers)
           if not tcfg.is_attention_layer(i)]
    assert rec
    for i in rec:
        for name in SCAN_LEAVES:
            g = tgrads["layers"][str(i)]["rec"][name]
            assert float(g.abs().max()) > 0, (i, name)


def test_hybrid_five_train_steps_match_reference(hybrid_setup):
    jcfg, tcfg, jparams, tparams = hybrid_setup
    jl, js, tl, ts = _run_steps(jcfg, tcfg, jparams, tparams,
                                _batches(jcfg, 5))
    np.testing.assert_allclose(tl, jl, **TOL)
    _assert_params_close(ts["params"], js["params"])
    assert int(ts["opt"]["step"]) == 5


# the hybrid's bf16 gradients against the reference's: at random SMOKE
# weights the reference's own bf16 gradients lie 3-6% from its fp32
# ones (each leaf's norm), so the dense tests' fixed 5% does not
# separate rounding from a fault here.  Each leaf is held instead to
# HYBRID_BF16_FACTOR times the reference's own bf16 distance from fp32,
# on the same batch (the factor chip_smoke.py holds the kernels to; the
# port lands at up to 1.11x it)
HYBRID_BF16_FACTOR = 2.0


def test_hybrid_bf16_compute_grads_near_reference(hybrid_setup):
    """The bf16 variant: loss within 2e-2, every gradient leaf within
    HYBRID_BF16_FACTOR times the reference's bf16 leaf's distance from
    its fp32 leaf."""
    jcfg, tcfg, jparams, tparams = hybrid_setup
    jcfg16 = dataclasses.replace(jcfg, compute_dtype=jnp.bfloat16)
    tcfg = dataclasses.replace(tcfg, compute_dtype=torch.bfloat16)
    batch = jax.tree.map(jnp.asarray, _batches(jcfg, 1, seed=3)[0])

    def cast(p):
        return p.astype(jnp.bfloat16) if p.ndim > 1 else p

    (jloss, _), jgrads = jax.value_and_grad(
        jmodel.loss_fn(jcfg16), has_aux=True)(
        jax.tree.map(cast, jparams), batch)
    _, jgrads32 = jax.value_and_grad(jmodel.loss_fn(jcfg), has_aux=True)(
        jparams, batch)
    tloss, _, tgrads = tstrategy.value_and_grad(tcfg)(
        tparams, jax.tree.map(lambda a: torch.from_numpy(np.asarray(a)),
                              batch))
    assert abs(float(tloss) - float(jloss)) < 2e-2
    for i, (a, b, c) in enumerate(zip(_leaves(tgrads),
                                      jax.tree.leaves(jgrads),
                                      jax.tree.leaves(jgrads32))):
        assert a.dtype == (torch.bfloat16 if b.ndim > 1 else torch.float32)
        a = a.float().numpy()
        b, c = (np.asarray(t, dtype=np.float32) for t in (b, c))
        rel = np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12)
        own = np.linalg.norm(b - c) / max(np.linalg.norm(c), 1e-12)
        assert rel <= HYBRID_BF16_FACTOR * own, (i, a.shape, rel, own)


def test_hybrid_remat_and_no_remat_grads_bit_identical(hybrid_setup,
                                                       monkeypatch):
    """The hybrid blocks run under the checkpoint (the reference's
    ``jax.checkpoint``) when cfg.remat is set: the backward recomputes
    the same forward (each recurrent layer's scan runs twice, once
    without remat), so the gradients are those without it, bit for
    bit."""
    _, tcfg, _, tparams = hybrid_setup
    assert tcfg.remat
    batch = _tbatch(_batches(tcfg, 1, seed=4)[0])
    n_rec = sum(not tcfg.is_attention_layer(i)
                for i in range(tcfg.num_layers))
    assert n_rec
    calls = []
    scan = trglru._scan

    def counted(*args, **kwargs):
        calls.append(1)
        return scan(*args, **kwargs)

    monkeypatch.setattr(trglru, "_scan", counted)
    out = {}
    for remat in (True, False):
        cfg = dataclasses.replace(tcfg, remat=remat)
        calls.clear()
        loss, _, grads = tstrategy.value_and_grad(cfg)(tparams, batch)
        assert len(calls) == n_rec * (2 if remat else 1), (remat, calls)
        out[remat] = (loss, _leaves(grads))
    assert torch.equal(out[True][0], out[False][0])
    for i, (a, b) in enumerate(zip(out[True][1], out[False][1])):
        assert torch.equal(a, b), i


# ---------------------------------------------------------------------------
# the ssm family
# ---------------------------------------------------------------------------

SSM = "rwkv6-3b"
# the time-mix leaves whose gradients come through the WKV's reverse
# alone (the r, k, v projections, the decay's LoRA and base, the bonus).
# decay_a is not among them: its gradient is decay_b-weighted, and
# decay_b starts at zero (the reference's init), so it is exactly zero on
# both sides at the first step
WKV_LEAVES = ("wr", "wk", "wv", "decay_b", "decay_base", "bonus")
# the ssm's fp32 gradients against the reference's: each leaf within
# SSM_GRAD_SHARE of its largest element (plus TOL's relative 1e-5).  At
# the first token the state is zero, the WKV's output is the bonus term
# alone and the per-head group norm's variance drops to ~1e-6, below its
# eps 1e-5, so its backward multiplies the fp32 rounding of its input by
# up to ~260 and carries it into every leaf behind it: both the port's
# and the reference's fp32 gradients lie 2-3e-4 of each leaf's largest
# element from an fp64 run of the port on the same batch, and 0.9-1.9e-4
# from each other.  A wiring fault moves a leaf by the order of its size
SSM_GRAD_SHARE = 1e-3


@pytest.fixture(scope="module")
def ssm_setup():
    jcfg, tcfg = jsmoke(SSM), tsmoke(SSM)
    jparams = jmodel.init_params(jcfg, jax.random.key(0))
    tparams = params_from_numpy(_np_tree(jparams), device="cpu")
    return jcfg, tcfg, jparams, tparams


def test_ssm_loss_fn_and_grads_match_reference(ssm_setup):
    jcfg, tcfg, jparams, tparams = ssm_setup
    batch = _batches(jcfg, 1)[0]
    (jloss, jmet), jgrads = jax.value_and_grad(
        jmodel.loss_fn(jcfg), has_aux=True)(
        jparams, jax.tree.map(jnp.asarray, batch))
    tloss, tmet, tgrads = tstrategy.value_and_grad(tcfg)(tparams,
                                                         _tbatch(batch))
    assert float(tloss) == pytest.approx(float(jloss), rel=1e-5)
    assert set(tmet) == set(jmet) == {"xent", "aux"}
    for i, (a, b) in enumerate(zip(_leaves(tgrads), jax.tree.leaves(jgrads))):
        b = np.asarray(b)
        np.testing.assert_allclose(
            a.numpy(), b, rtol=TOL["rtol"],
            atol=SSM_GRAD_SHARE * float(np.abs(b).max()), err_msg=f"leaf {i}")
    tm = tgrads["blocks"]["tm"]
    for name in WKV_LEAVES:
        for i in range(tcfg.num_layers):
            assert float(tm[name][i].abs().max()) > 0, (i, name)


# 5 steps of the ssm against the reference's: the first-token rounding
# above reaches the losses and, through AdamW (which moves an element by
# ~lr whatever its gradient's size), the params, so they are held by
# what a fault would move.  Losses within SSM_LOSS_ATOL: 7.3e-5 apart
# measured, each up to 1.6e-4 from an fp64 run of the port, where a step
# moves the loss by ~0.05.  Each leaf's update (final minus initial
# params) within SSM_UPDATE_RTOL of the reference's update, in norm: up
# to 0.005 measured, each side up to 0.006 from the fp64 run's update;
# a missing or wrong gradient moves it by the order of its size
SSM_LOSS_ATOL = 5e-4
SSM_UPDATE_RTOL = 0.02


def test_ssm_five_train_steps_match_reference(ssm_setup):
    jcfg, tcfg, jparams, tparams = ssm_setup
    jl, js, tl, ts = _run_steps(jcfg, tcfg, jparams, tparams,
                                _batches(jcfg, 5))
    np.testing.assert_allclose(tl, jl, rtol=0, atol=SSM_LOSS_ATOL)
    for i, (a, b, p0) in enumerate(zip(_leaves(ts["params"]),
                                       jax.tree.leaves(js["params"]),
                                       _leaves(tparams))):
        p0 = p0.numpy()
        da, db = a.numpy() - p0, np.asarray(b) - p0
        rel = np.linalg.norm(da - db) / np.linalg.norm(db)
        assert rel <= SSM_UPDATE_RTOL, (i, rel)
    assert int(ts["opt"]["step"]) == 5


# the ssm's bf16 gradients against the reference's, held as the hybrid's
# are: each leaf within SSM_BF16_FACTOR times the reference's own bf16
# distance from its fp32 gradient on the same batch
SSM_BF16_FACTOR = 2.0


def test_ssm_bf16_compute_grads_near_reference(ssm_setup):
    """The bf16 variant: loss within 2e-2, every gradient leaf within
    SSM_BF16_FACTOR times the reference's bf16 leaf's distance from its
    fp32 leaf."""
    jcfg, tcfg, jparams, tparams = ssm_setup
    jcfg16 = dataclasses.replace(jcfg, compute_dtype=jnp.bfloat16)
    tcfg = dataclasses.replace(tcfg, compute_dtype=torch.bfloat16)
    batch = jax.tree.map(jnp.asarray, _batches(jcfg, 1, seed=3)[0])

    def cast(p):
        return p.astype(jnp.bfloat16) if p.ndim > 1 else p

    (jloss, _), jgrads = jax.value_and_grad(
        jmodel.loss_fn(jcfg16), has_aux=True)(
        jax.tree.map(cast, jparams), batch)
    _, jgrads32 = jax.value_and_grad(jmodel.loss_fn(jcfg), has_aux=True)(
        jparams, batch)
    tloss, _, tgrads = tstrategy.value_and_grad(tcfg)(
        tparams, jax.tree.map(lambda a: torch.from_numpy(np.asarray(a)),
                              batch))
    assert abs(float(tloss) - float(jloss)) < 2e-2
    for i, (a, b, c) in enumerate(zip(_leaves(tgrads),
                                      jax.tree.leaves(jgrads),
                                      jax.tree.leaves(jgrads32))):
        assert a.dtype == (torch.bfloat16 if b.ndim > 1 else torch.float32)
        a = a.float().numpy()
        b, c = (np.asarray(t, dtype=np.float32) for t in (b, c))
        rel = np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12)
        own = np.linalg.norm(b - c) / max(np.linalg.norm(c), 1e-12)
        assert rel <= SSM_BF16_FACTOR * own, (i, a.shape, rel, own)


def test_ssm_remat_and_no_remat_grads_bit_identical(ssm_setup, monkeypatch):
    """The RWKV-6 blocks run under the checkpoint (the reference's
    ``jax.checkpoint``) when cfg.remat is set: the backward recomputes
    the same forward, so each layer's WKV runs twice (once without
    remat) and the gradients are those without it, bit for bit."""
    _, tcfg, _, tparams = ssm_setup
    assert tcfg.remat
    batch = _tbatch(_batches(tcfg, 1, seed=4)[0])
    calls = []
    wkv = trwkv.rwkv6_wkv

    def counted(*args, **kwargs):
        calls.append(1)
        return wkv(*args, **kwargs)

    monkeypatch.setattr(trwkv, "rwkv6_wkv", counted)
    out = {}
    for remat in (True, False):
        cfg = dataclasses.replace(tcfg, remat=remat)
        calls.clear()
        loss, _, grads = tstrategy.value_and_grad(cfg)(tparams, batch)
        assert len(calls) == tcfg.num_layers * (2 if remat else 1), (
            remat, len(calls))
        out[remat] = (loss, _leaves(grads))
    assert torch.equal(out[True][0], out[False][0])
    for i, (a, b) in enumerate(zip(out[True][1], out[False][1])):
        assert torch.equal(a, b), i
