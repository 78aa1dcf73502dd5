"""The port's sharded train step (``launch.strategy.ShardedTrainStep``)
on 4 gloo ranks, a (2, 2) ("data", "model") mesh, against the
reference's ``jit_train_step`` on a 4-device CPU mesh of Auto axes, two
steps from the reference's initial state on the same (4, 32) batches:

* smollm-135m SMOKE (3 heads, 1 KV head: the heads stay whole on the
  model axis, the FFN, vocab and embedding split as the rule table
  says), deepseek-moe-16b SMOKE with ``moe_impl="ep"`` (moe_ep: per-rank
  routing and capacity, two all-to-alls a layer) and with the default
  ``moe_impl`` (moe_gspmd on the tokens gathered whole: its global sort
  needs every token), and smollm with
  ``bf16_grad_reduce`` (the ``bf16_grads`` variant: ``DenseBf16Grad``
  and the gradients reduced before the fp32 cast);
* losses within TOL, every updated parameter and both AdamW moments
  within PARAM_ATOL (``tests/test_torch_train_step.py``'s tolerances);
* each rank holds only its blocks: its local parameter bytes equal
  ``sharded_param_bytes``; the counter sees the FSDP all-gathers and a
  gradient reduction;
* smollm's sharded step equals the port's one-process
  ``make_train_step`` (losses TOL, parameters PARAM_ATOL);
* with plain tensors a ``ParallelCtx`` changes nothing: the one-process
  step under an installed context is bit-identical to the step with
  none (every ``shard_activation`` site is the identity there);
* at world size 1 (a gloo group in this process, a 1 x 1 mesh, as the
  card's smoke runs it through NCCL) the sharded step equals
  ``TrainStep`` bit for bit over 3 steps, the EP step issuing its
  all-to-alls; a second process group, and a CUDA mesh without a card,
  are refused;
* granite-3-8b SMOKE, whose vocab of 129 the model axis does not
  divide: the "logits" kind keeps the vocab whole (split on the batch
  only), so the loss and the step match the reference; on fixed logits
  at V = 127 the sharded ``softmax_xent`` equals the plain one, and
  ``_xent_sharded`` refuses logits whose vocab is split unevenly;
* mixtral-8x7b SMOKE, with the default ``moe_impl`` and with "ep": a
  MoE with no shared experts and no dense first layer, every layer
  windowed (16 slots);
* each rank's counted collectives, count and bytes by kind, equal the
  dry run's record of the same cell (``repro_torch.launch.dryrun`` on a
  "cpu"-typed fake 2 x 2 mesh, made in the reference's subprocess).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tests._torch_mesh import auto_mesh, run_reference, save, spawn  # noqa: E402

CASES = {
    "smollm": ("smollm-135m", {}),
    "deepseek_ep": ("deepseek-moe-16b", {"moe_impl": "ep"}),
    "deepseek_gspmd": ("deepseek-moe-16b", {}),
    "smollm_bf16_grads": ("smollm-135m", {"bf16_grad_reduce": True}),
    # an odd vocab (129), which the model axis does not divide: the
    # logits keep it whole
    "granite": ("granite-3-8b", {}),
    # no shared experts, no dense first layer, a 16-slot window
    "mixtral": ("mixtral-8x7b", {}),
    "mixtral_ep": ("mixtral-8x7b", {"moe_impl": "ep"}),
}
TOL = dict(atol=1e-5, rtol=1e-5)
PARAM_ATOL = 1e-4
B, S, STEPS = 4, 32, 2


def _cfg(get_smoke, case):
    arch, knobs = CASES[case]
    return dataclasses.replace(get_smoke(arch), **knobs)


def _tokens(vocab: int):
    rng = np.random.default_rng(3)
    return rng.integers(0, vocab, (STEPS, B, S), dtype=np.int32)


def reference(out):
    import jax

    from repro.configs import get_smoke
    from repro.launch import strategy
    from repro.models.config import ShapeConfig
    from repro.optim import AdamWConfig
    from repro.parallel.ctx import parallel_ctx

    mesh = auto_mesh()
    res = {}
    for case in CASES:
        cfg = _cfg(get_smoke, case)
        fn, _, ctx = strategy.jit_train_step(
            cfg, ShapeConfig("t", "train", S, B), mesh, AdamWConfig())
        state = strategy.init_train_state(cfg, jax.random.PRNGKey(0), mesh)
        res[case, "state0"] = jax.tree.map(np.asarray, state)
        losses = []
        with parallel_ctx(ctx):
            for toks in _tokens(cfg.vocab_size):
                state, m = fn(state, {"tokens": toks})
                losses.append(float(m["loss"]))
        res[case, "losses"] = losses
        res[case, "state"] = jax.tree.map(np.asarray, state)
    res["dryrun"] = _dryrun_records()
    save(res, out)


def _dryrun_records():
    """Each case's dry-run collectives (count and bytes by kind) on a
    "cpu"-typed fake 2 x 2 mesh: the plan the gloo ranks run."""
    from repro_torch.configs import get_smoke
    from repro_torch.launch import dryrun
    from repro_torch.models.config import ShapeConfig

    out = {}
    for case in CASES:
        cfg = _cfg(get_smoke, case)
        c = dryrun.run_cell(cfg.name, ShapeConfig("t", "train", S, B),
                            save=False, cfg_override=cfg, mesh_shape=(2, 2),
                            mesh_device="cpu")["collectives"]
        out[case] = (c["count_by_kind"], c["bytes_by_kind"])
    return out


def port(rank, mesh, ref):
    from repro_torch.configs import get_smoke
    from repro_torch.launch import strategy
    from repro_torch.optim import AdamWConfig
    from repro_torch.parallel.ctx import parallel_ctx
    from repro_torch.parallel.sharding import local_bytes, sharded_param_bytes
    from repro_torch.tree import tree_map

    res = {}
    for case in CASES:
        cfg = _cfg(get_smoke, case)
        state0 = tree_map(lambda a: torch.from_numpy(np.array(a)),
                          ref[case, "state0"])
        st = strategy.ShardedTrainStep(cfg, AdamWConfig(), mesh, state0, B,
                                       S, step_impl="eager")
        losses = [float(st({"tokens": torch.from_numpy(t)})["loss"])
                  for t in _tokens(cfg.vocab_size)]
        res[case] = {
            "losses": losses,
            "state": tree_map(lambda t: t.full_tensor().numpy(), st.state),
            "local_bytes": local_bytes(st.state["params"]),
            "want_bytes": sharded_param_bytes(cfg, mesh),
            "kinds": st.collectives.stats().count_by_kind,
            "bytes": st.collectives.stats().bytes_by_kind,
        }
        if case == "smollm" and rank == 0:
            step = strategy.make_train_step(cfg, AdamWConfig())
            ctx = strategy.make_ctx(cfg, mesh)
            plain, under_ctx = state0, state0
            one = []
            for t in _tokens(cfg.vocab_size):
                batch = {"tokens": torch.from_numpy(t)}
                plain, m = step(plain, batch)
                with parallel_ctx(ctx):
                    under_ctx, _ = step(under_ctx, batch)
                one.append(float(m["loss"]))
            res[case, "one"] = {"losses": one, "state": tree_map(
                lambda t: t.numpy(), plain)}
            res[case, "ctx_identical"] = all(
                torch.equal(a, b) for a, b in zip(
                    _leaves(plain), _leaves(under_ctx)))
    res["xent"] = _uneven_xent(mesh)
    return res


def _uneven_xent(mesh):
    """``softmax_xent`` of fixed (B, 8, 127) logits under the mesh's
    context: the plain value, the sharded one (the logits laid out by
    the "logits" kind), their placements there and at 128, and the
    error of logits split unevenly on the vocab."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.configs import get_smoke
    from repro_torch.launch import strategy
    from repro_torch.models import layers
    from repro_torch.parallel.ctx import parallel_ctx, shard_activation
    from repro_torch.parallel.sharding import distribute

    g = torch.Generator().manual_seed(1)
    logits = 3 * torch.randn(B, 8, 128, generator=g)
    labels = torch.randint(0, 127, (B, 8), generator=g, dtype=torch.int32)
    rows = (Shard(0), Replicate())
    out = {"plain": float(layers.softmax_xent(logits[..., :127], labels))}
    with parallel_ctx(strategy.make_ctx(get_smoke("smollm-135m"), mesh)):
        lab = distribute(labels, rows, mesh)
        for v in (127, 128):
            lg = shard_activation(distribute(logits[..., :v].contiguous(),
                                             rows, mesh), "logits")
            out[v, "placements"] = tuple(lg.placements)
            out[v, "sharded"] = float(layers.softmax_xent(lg, lab)
                                      .to_local())
        uneven = distribute(logits[..., :127].contiguous(), rows,
                            mesh).redistribute(mesh, (Shard(0), Shard(2)))
        try:
            layers.softmax_xent(uneven, lab)
        except ValueError as e:
            out["refused"] = str(e)
    return out


def _leaves(tree):
    from repro_torch.tree import flatten

    return flatten(tree)[0]


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded_train")
    ref = run_reference("test_torch_sharded_train", "reference",
                        tmp / "ref.pkl")
    return ref, spawn(port, tmp / "port", ref)


def _items(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _items(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, np.asarray(tree)


def _assert_state(got, want):
    want = dict(_items(want))
    names = set()
    for name, v in _items(got):
        names.add(name)
        np.testing.assert_allclose(v, want[name], atol=PARAM_ATOL, rtol=0,
                                   err_msg=name)
    assert names == set(want)


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_step_matches_reference(results, case):
    ref, ranks = results
    got = ranks[0][case]
    np.testing.assert_allclose(got["losses"], ref[case, "losses"], **TOL)
    _assert_state(got["state"], ref[case, "state"])


@pytest.mark.parametrize("case", list(CASES))
def test_each_rank_holds_its_shard(results, case):
    _, ranks = results
    for r in ranks:
        assert r[case]["local_bytes"] == r[case]["want_bytes"]
    full = sum(np.asarray(v).nbytes
               for _, v in _items(results[0][case, "state0"]["params"]))
    assert ranks[0][case]["want_bytes"] < full


@pytest.mark.parametrize("case", list(CASES))
def test_counter_sees_gathers_and_reductions(results, case):
    _, ranks = results
    kinds = ranks[0][case]["kinds"]
    assert kinds.get("all-gather", 0) > 0
    assert kinds.get("reduce-scatter", 0) + kinds.get("all-reduce", 0) > 0
    if case.endswith("_ep"):
        assert kinds.get("all-to-all", 0) > 0


@pytest.mark.parametrize("case", list(CASES))
def test_collectives_equal_the_dry_run_record(results, case):
    ref, ranks = results
    for r in ranks:
        assert (r[case]["kinds"], r[case]["bytes"]) == ref["dryrun"][case]


def test_sharded_step_matches_one_process_step(results):
    _, ranks = results
    got, one = ranks[0]["smollm"], ranks[0]["smollm", "one"]
    np.testing.assert_allclose(got["losses"], one["losses"], **TOL)
    _assert_state(got["state"], one["state"])


def test_sharded_xent_at_an_uneven_vocab_equals_plain(results):
    from torch.distributed.tensor import Replicate, Shard

    _, ranks = results
    for r in ranks:
        x = r["xent"]
        assert x[127, "placements"] == (Shard(0), Replicate())
        assert x[128, "placements"] == (Shard(0), Shard(2))
        np.testing.assert_allclose(x[127, "sharded"], x["plain"], **TOL)


def test_xent_refuses_an_uneven_vocab_block(results):
    _, ranks = results
    for r in ranks:
        assert "does not split evenly" in r["xent"].get("refused", "")


def test_plain_step_under_context_is_bit_identical(results):
    _, ranks = results
    assert ranks[0]["smollm", "ctx_identical"]


@pytest.fixture(scope="module")
def world_one(tmp_path_factory):
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_distributed, make_dev_mesh

    store = tmp_path_factory.mktemp("world1") / "store"
    init_distributed("cpu", f"file://{store}")
    try:
        yield make_dev_mesh(1, 1, device="cpu")
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("case", list(CASES))
def test_world_one_step_is_train_step_bit_for_bit(world_one, case):
    from repro_torch.configs import get_smoke
    from repro_torch.launch import strategy
    from repro_torch.optim import AdamWConfig
    from repro_torch.tree import tree_map

    cfg = _cfg(get_smoke, case)
    s0 = strategy.init_train_state(cfg, torch.Generator().manual_seed(0),
                                   "cpu")
    ref = strategy.TrainStep(cfg, AdamWConfig(), s0, B, S, "eager")
    got = strategy.ShardedTrainStep(cfg, AdamWConfig(), world_one, s0, B,
                                    S, "eager")
    for t in _tokens(cfg.vocab_size):
        batch = {"tokens": torch.from_numpy(t)}
        a = {k: v.clone() for k, v in ref(batch).items()}
        b = got(batch)
        assert all(torch.equal(a[k], b[k]) for k in a)
    assert all(torch.equal(x, y) for x, y in zip(
        _leaves(ref.state), _leaves(tree_map(lambda t: t.to_local(),
                                             got.state))))
    kinds = got.collectives.stats().count_by_kind
    # EP: two all-to-alls a MoE layer, in the forward, remat's recompute
    # and the backward
    moe_layers = cfg.num_layers - cfg.first_k_dense
    assert kinds == ({"all-to-all": 6 * moe_layers} if cfg.moe_impl == "ep"
                     else {})


def test_mesh_refuses_a_second_group_and_a_missing_card(world_one):
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_distributed, make_dev_mesh

    with pytest.raises(RuntimeError, match="already started"):
        init_distributed("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            make_dev_mesh(1, 1)
    assert dist.get_backend() == "gloo"
