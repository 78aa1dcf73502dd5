"""The port's expert- and tensor-parallel MoE (``repro_torch.parallel.
moe_ep``) on 4 gloo ranks, a (2, 2) ("data", "model") mesh, against the
reference's ``moe_ep`` / ``moe_tp`` on a 4-device CPU mesh of Auto axes:
the first MoE block of deepseek-moe-16b (8 experts, 2 shared) and
mixtral-8x7b SMOKE, on the reference's weights, x (4, 16, d) split on
the batch over data and (EP) on the sequence over model.

Each case checks the output and the load-balancing loss within TOL and
the gradient of sum(out * cot) + 0.5 * aux with respect to x and every
leaf of the block within TOL, on plain normal inputs and on crowded ones
(every token near one vector, so every rank routes its tokens to the
same experts and its per-device capacity drops some: there the
reference's moe_ep differs from its moe_gspmd, which the test asserts).
A forward of moe_ep issues two all-to-alls of the packed (E, cap, d)
buffer: the counter's all-to-all bytes are 2 x E x cap x d x itemsize.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tests._torch_mesh import auto_mesh, run_reference, save, spawn  # noqa: E402

ARCHS = ("deepseek-moe-16b", "mixtral-8x7b")
INPUTS = ("plain", "crowded")
IMPLS = ("ep", "tp")
TOL = dict(atol=1e-5, rtol=1e-5)
B, S = 4, 16
C_AUX = 0.5


def _inputs(d: int, kind: str):
    rng = np.random.default_rng(7)
    if kind == "plain":
        x = rng.standard_normal((B, S, d))
    else:
        x = rng.standard_normal((1, 1, d)) + 0.05 * rng.standard_normal(
            (B, S, d))
    cot = rng.standard_normal((B, S, d))
    return x.astype(np.float32), cot.astype(np.float32)


def reference(out):
    """The reference's side (4 host devices): params, and per case the
    output, aux and gradients, and moe_gspmd's output."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_smoke
    from repro.models import model
    from repro.models.moe import moe_gspmd
    from repro.parallel.moe_ep import moe_ep, moe_tp

    mesh = auto_mesh()
    res = {}
    for arch in ARCHS:
        cfg = dataclasses.replace(get_smoke(arch), moe_impl="ep")
        params = model.init_params(cfg, jax.random.PRNGKey(0))
        res[arch, "params"] = jax.tree.map(np.asarray, params)
        p = jax.tree.map(lambda a: a[0], params["blocks"])["moe"]
        for impl, f in (("ep", moe_ep), ("tp", moe_tp)):
            def loss(x, p, cot, f=f):
                o, aux = f(x, p, cfg, mesh)
                return jnp.sum(o * cot) + C_AUX * aux, (o, aux)

            vg = jax.jit(jax.value_and_grad(loss, argnums=(0, 1),
                                            has_aux=True))
            for kind in INPUTS:
                x, cot = _inputs(cfg.d_model, kind)
                (_, (o, aux)), (gx, gp) = vg(x, p, cot)
                res[arch, kind, impl] = {
                    "out": np.asarray(o), "aux": float(aux),
                    "gx": np.asarray(gx),
                    "gp": jax.tree.map(np.asarray, gp)}
        for kind in INPUTS:
            x, _ = _inputs(cfg.d_model, kind)
            res[arch, kind, "gspmd"] = np.asarray(
                jax.jit(lambda x, p: moe_gspmd(x, p, cfg)[0])(x, p))
    save(res, out)


def port(rank, mesh, ref):
    """The port's side on one rank: the same cases, gathered to full
    tensors; and the all-to-all bytes of one moe_ep forward."""
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.configs import get_smoke
    from repro_torch.core.collectives import CollectiveCounter
    from repro_torch.launch.strategy import make_ctx
    from repro_torch.models.init import params_from_numpy
    from repro_torch.models.moe import capacity
    from repro_torch.parallel.ctx import parallel_ctx
    from repro_torch.parallel.moe_ep import moe_ep, moe_tp
    from repro_torch.parallel.sharding import distribute, shard_params
    from repro_torch.tree import flatten, tree_map, unflatten

    res = {}
    for arch in ARCHS:
        cfg = dataclasses.replace(get_smoke(arch), moe_impl="ep")
        ctx = make_ctx(cfg, mesh)
        params = shard_params(params_from_numpy(ref[arch, "params"], "cpu"),
                              cfg, mesh)
        p = tree_map(lambda a: a[0].detach().requires_grad_(),
                     params["blocks"]["moe"])
        leaves, structure = flatten(p)
        act = ctx.placements("act", 3)
        for impl, f in (("ep", moe_ep), ("tp", moe_tp)):
            for kind in INPUTS:
                xn, cotn = _inputs(cfg.d_model, kind)
                x = distribute(torch.from_numpy(xn), act,
                               mesh).requires_grad_()
                with parallel_ctx(ctx):
                    o, aux = f(x, p, cfg, mesh)
                    cot = distribute(torch.from_numpy(cotn), tuple(
                        Replicate() if q.is_partial() else q
                        for q in o.placements), mesh)
                    loss = (o * cot).sum() + C_AUX * aux
                    grads = torch.autograd.grad(loss, [x] + leaves)
                full = [g.full_tensor().numpy() for g in grads]
                res[arch, kind, impl] = {
                    "out": o.full_tensor().detach().numpy(),
                    "aux": float(aux.full_tensor()),
                    "gx": full[0], "gp": unflatten(structure, full[1:])}
        xn, _ = _inputs(cfg.d_model, "plain")
        x = distribute(torch.from_numpy(xn), act, mesh)
        counter = CollectiveCounter()
        with parallel_ctx(ctx), torch.no_grad(), counter:
            moe_ep(x, p, cfg, mesh)
        t_local = (B // 2) * (S // 2)
        res[arch, "a2a"] = (counter.stats().bytes_by_kind.get("all-to-all"),
                            counter.stats().count_by_kind.get("all-to-all"),
                            2 * cfg.num_experts * capacity(t_local, cfg)
                            * cfg.d_model * 4)
        assert isinstance(o, DTensor)
    return res if rank == 0 else None


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("moe_ep")
    ref = run_reference("test_torch_moe_ep", "reference", tmp / "ref.pkl")
    return ref, spawn(port, tmp / "port", ref)[0]


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("kind", INPUTS)
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_matches_reference(results, arch, kind, impl):
    ref, got = results
    r, g = ref[arch, kind, impl], got[arch, kind, impl]
    np.testing.assert_allclose(g["out"], r["out"], **TOL)
    np.testing.assert_allclose(g["aux"], r["aux"], **TOL)
    np.testing.assert_allclose(g["gx"], r["gx"], **TOL)
    flat_r = dict(_items(r["gp"]))
    for name, v in _items(g["gp"]):
        np.testing.assert_allclose(v, flat_r[name], **TOL, err_msg=name)
    assert set(flat_r) == {n for n, _ in _items(g["gp"])}


@pytest.mark.parametrize("arch", ARCHS)
def test_crowded_inputs_drop_tokens(results, arch):
    """Per-device capacity drops tokens on crowded inputs: there the
    reference's moe_ep differs from its global moe_gspmd."""
    ref, _ = results
    crowded = np.abs(ref[arch, "crowded", "ep"]["out"]
                     - ref[arch, "crowded", "gspmd"]).max()
    assert crowded > 1e-3


@pytest.mark.parametrize("arch", ARCHS)
def test_all_to_all_bytes(results, arch):
    _, got = results
    nbytes, count, want = got[arch, "a2a"]
    assert count == 2
    assert nbytes == want


def _items(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _items(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, np.asarray(tree)
