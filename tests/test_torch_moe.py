"""MoE FFN of the port (``repro_torch.models.moe``) against the
reference's (``repro.models.moe``) for deepseek-moe-16b and mixtral-8x7b
SMOKE, fp32 on the CPU, on the reference's params (one MoE block,
through ``params_from_numpy``) and the same numpy inputs: the router
(gates, expert ids, aux loss), the capacity, the sort-based dispatch,
the expert FFN, and the whole block both with token drops (the config's
capacity factor 1.25 and inputs that crowd a few experts) and with the
batched decode's raised capacity (no drops).

Tolerances: expert ids, capacity and dispatch exact; gates and aux
atol/rtol 1e-6; block and FFN outputs atol/rtol 1e-5 — fp32 sums in
another order, the port summing each token's k rows in top-k order
where the reference scatter-adds in expert order.  The block's
gradients (against ``jax.grad`` of the reference's ``moe_gspmd``):
rtol 1e-5 and atol 2e-6 of the leaf's largest entry, and each leaf's
relative distance (2-norm) within 1e-5 — a weight's gradient sums one
term per routed token, and the crowded inputs that force drops make
those terms share a sign, so entries reach ~400 and carry fp32
summation-order error of ~3e-7 of that (measured), not of themselves.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke as jsmoke  # noqa: E402
from repro.models import init as jinit  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch.configs import get_smoke as tsmoke  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models.init import params_from_numpy  # noqa: E402
from repro_torch.serve.batched_executor import decode_config  # noqa: E402

ARCHS = ["deepseek-moe-16b", "mixtral-8x7b"]
OUT_TOL = dict(atol=1e-5, rtol=1e-5)
GATE_TOL = dict(atol=1e-6, rtol=1e-6)
GRAD_RTOL = 1e-5
GRAD_ATOL_SHARE = 2e-6


def _block(arch):
    """The reference's first MoE block params, both sides."""
    jcfg, tcfg = jsmoke(arch), tsmoke(arch)
    jp = jinit.init_params(jcfg, jax.random.key(3))
    moe = jax.tree.map(lambda a: np.asarray(a[0]), jp["blocks"]["moe"])
    return jcfg, tcfg, jax.tree.map(jnp.asarray, moe), \
        params_from_numpy(moe, "cpu")


def _x(cfg, b, s, seed, crowd=0.0):
    """Normal inputs; ``crowd`` adds one shared direction to every token,
    so the router sends most tokens to the same few experts."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    return x + crowd * rng.standard_normal(cfg.d_model).astype(np.float32)


@pytest.mark.parametrize("arch", ARCHS)
def test_router_topk_matches_reference(arch):
    jcfg, tcfg, jp, tp = _block(arch)
    x = _x(tcfg, 1, 40, seed=1)[0]
    jg, ji, ja = jmoe.router_topk(jnp.asarray(x), jp["router"], jcfg)
    tg, ti, ta = tmoe.router_topk(torch.from_numpy(x), tp["router"], tcfg)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), **GATE_TOL)
    np.testing.assert_allclose(ta.item(), float(ja), **GATE_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_capacity_matches_reference(arch):
    jcfg, tcfg = jsmoke(arch), tsmoke(arch)
    for cf in (1.0, 1.25, 2.0, float(tcfg.num_experts)):
        jc = dataclasses.replace(jcfg, capacity_factor=cf)
        tc = dataclasses.replace(tcfg, capacity_factor=cf)
        for n in (1, 3, 8, 40, 77, 300):
            assert tmoe.capacity(n, tc) == jmoe.capacity(n, jc)


@pytest.mark.parametrize("arch", ARCHS)
def test_build_dispatch_matches_reference(arch):
    jcfg, tcfg = jsmoke(arch), tsmoke(arch)
    n, k = 50, tcfg.experts_per_token
    rng = np.random.default_rng(5)
    # skewed expert choice, distinct within a token, so some overflow
    idx = np.stack([rng.choice(tcfg.num_experts, k, replace=False,
                               p=np.linspace(3, 1, tcfg.num_experts) /
                               np.linspace(3, 1, tcfg.num_experts).sum())
                    for _ in range(n)]).astype(np.int32)
    cap = tmoe.capacity(n, tcfg)
    ref = jmoe.build_dispatch(jnp.asarray(idx), n, cap, jcfg)
    got = tmoe.build_dispatch(torch.from_numpy(idx).long(), n, cap, tcfg)
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    assert not bool(got[3].all())                     # tokens were dropped


@pytest.mark.parametrize("arch", ARCHS)
def test_expert_ffn_matches_reference(arch):
    jcfg, tcfg, jp, tp = _block(arch)
    xe = _x(tcfg, tcfg.num_experts, 8, seed=6)
    ref = jmoe.expert_ffn(jnp.asarray(xe), jp["experts"], jcfg)
    got = tmoe.expert_ffn(torch.from_numpy(xe), tp["experts"], tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **OUT_TOL)


@pytest.mark.parametrize("drops", [True, False], ids=["drops", "decode_cf"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_block_matches_reference(arch, drops):
    jcfg, tcfg, jp, tp = _block(arch)
    if not drops:
        jcfg = dataclasses.replace(
            jcfg, capacity_factor=float(jcfg.num_experts))
        tcfg = decode_config(tcfg)
        assert tcfg.capacity_factor == jcfg.capacity_factor
    x = _x(tcfg, 2, 24, seed=7, crowd=3.0 if drops else 0.0)
    t = 2 * 24
    _, idx, _ = tmoe.router_topk(torch.from_numpy(x).reshape(t, -1),
                                 tp["router"], tcfg)
    keep = tmoe.build_dispatch(idx, t, tmoe.capacity(t, tcfg), tcfg)[3]
    assert bool(keep.all()) != drops                  # the case it claims
    ref, raux = jmoe.moe_block(jnp.asarray(x), jp, jcfg)
    got, gaux = tmoe.moe_block(torch.from_numpy(x), tp, tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **OUT_TOL)
    np.testing.assert_allclose(gaux.item(), float(raux), **GATE_TOL)


@pytest.mark.parametrize("drops", [True, False], ids=["drops", "decode_cf"])
def test_expert_counts_are_the_kept_rows(drops):
    """``expert_counts`` is each expert's number of kept assignments: the
    rows its buffer holds, the rest of which are zero."""
    tcfg = tsmoke("deepseek-moe-16b")
    if not drops:
        tcfg = decode_config(tcfg)
    x = _x(tcfg, 2, 24, seed=8, crowd=3.0 if drops else 0.0)[0]
    _, p = _block("deepseek-moe-16b")[2:]
    _, idx, _ = tmoe.router_topk(torch.from_numpy(x), p["router"], tcfg)
    t = x.shape[0]
    cap = tmoe.capacity(t, tcfg)
    _, e_sorted, _, keep, _ = tmoe.build_dispatch(idx, t, cap, tcfg)
    want = torch.zeros(tcfg.num_experts, dtype=torch.int32)
    want.index_add_(0, e_sorted[keep], torch.ones(int(keep.sum()),
                                                  dtype=torch.int32))
    counts = tmoe.expert_counts(idx, cap, tcfg)
    assert counts.dtype == torch.int32 and torch.equal(counts, want)
    assert bool((counts == cap).any()) == drops


@pytest.mark.parametrize("drops", [True, False], ids=["drops", "decode_cf"])
def test_moe_gspmd_with_counts_matches_reference(drops, monkeypatch):
    """deepseek SMOKE: ``moe_gspmd`` hands every grouped matmul the
    experts' row counts and still matches the reference's ``moe_block``
    (which has none) to 1e-4."""
    jcfg, tcfg, jp, tp = _block("deepseek-moe-16b")
    if not drops:
        jcfg = dataclasses.replace(
            jcfg, capacity_factor=float(jcfg.num_experts))
        tcfg = decode_config(tcfg)
    seen = []
    real = tmoe.moe_gmm

    def spy(x, w, counts=None, **kw):
        seen.append(counts)
        return real(x, w, counts, **kw)

    monkeypatch.setattr(tmoe, "moe_gmm", spy)
    x = _x(tcfg, 2, 24, seed=9, crowd=3.0 if drops else 0.0)
    ref, _ = jmoe.moe_block(jnp.asarray(x), jp, jcfg)
    got, _ = tmoe.moe_gspmd(torch.from_numpy(x), tp, tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4,
                               rtol=1e-4)
    assert len(seen) == 3 and all(c is not None for c in seen)
    assert bool((seen[0] < tmoe.capacity(48, tcfg)).any())


def _np_leaves(tree, prefix=""):
    """{dotted name: numpy array} of a nested dict (either package)."""
    out = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_np_leaves(v, name + "."))
        else:
            out[name] = np.asarray(v.detach().numpy() if hasattr(v, "detach")
                                   else v, dtype=np.float32)
    return out


@pytest.mark.parametrize("part", ["out", "aux"])
@pytest.mark.parametrize("drops", [True, False], ids=["drops", "decode_cf"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_block_gradients_match_jax_grad(arch, drops, part):
    """The block's gradients for x, the router, the routed experts and
    the shared experts against ``jax.grad`` of the reference's
    ``moe_gspmd``, fp32, OUT_TOL: for a random cotangent of the output
    (``part="out"``), and for the load-balancing loss alone
    (``part="aux"``: through the router's probabilities only).  The
    routing is asserted equal first, so a near-tie would show as such."""
    jcfg, tcfg, jp, tp = _block(arch)
    if not drops:
        jcfg = dataclasses.replace(
            jcfg, capacity_factor=float(jcfg.num_experts))
        tcfg = decode_config(tcfg)
    x = _x(tcfg, 2, 24, seed=10, crowd=3.0 if drops else 0.0)
    cot = np.random.default_rng(11).standard_normal(x.shape).astype(
        np.float32)
    c_out, c_aux = (1.0, 0.0) if part == "out" else (0.0, 1.0)
    _, jidx, _ = jmoe.router_topk(jnp.asarray(x).reshape(48, -1),
                                  jp["router"], jcfg)
    _, tidx, _ = tmoe.router_topk(torch.from_numpy(x).reshape(48, -1),
                                  tp["router"], tcfg)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))

    def jloss(xx, pp):
        out, aux = jmoe.moe_gspmd(xx, pp, jcfg)
        return c_out * jnp.sum(out * cot) + c_aux * aux

    jgx, jgp = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x), jp)
    tx = torch.from_numpy(x).requires_grad_()
    tleaves = {k: v.detach().clone().requires_grad_()
               for k, v in _flat_torch(tp).items()}
    out, aux = tmoe.moe_gspmd(tx, _unflat(tleaves), tcfg)
    (c_out * (out * torch.from_numpy(cot)).sum() + c_aux * aux).backward()
    want = {"x": np.asarray(jgx), **_np_leaves(jgp)}
    got = {"x": tx.grad.numpy()}
    got.update({n: (leaf.grad if leaf.grad is not None
                    else torch.zeros_like(leaf)).numpy()
                for n, leaf in tleaves.items()})
    assert set(want) == set(got)
    for name, g in got.items():
        w = want[name]
        scale = float(np.abs(w).max())
        np.testing.assert_allclose(g, w, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL_SHARE * scale,
                                   err_msg=name)
        assert (np.linalg.norm(g - w)
                <= GRAD_RTOL * max(np.linalg.norm(w), 1e-30)), name
    if part == "aux":                   # only the router and x move it
        assert all(float(tleaves[n].grad.abs().max()) == 0
                   for n in tleaves if n != "router"
                   if tleaves[n].grad is not None)


def _flat_torch(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_torch(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def _unflat(flat):
    tree = {}
    for name, v in flat.items():
        node = tree
        *path, last = name.split(".")
        for p in path:
            node = node.setdefault(p, {})
        node[last] = v
    return tree


def test_expand_then_permute_dispatch_equals_the_gather():
    """The dispatch's rows, each token's k copies permuted by ``order``,
    give ``x2d[tok]``'s values and, for an integer cotangent (exact
    sums), its gradient bit for bit."""
    tcfg = tsmoke("deepseek-moe-16b")
    t, k, d = 40, tcfg.experts_per_token, tcfg.d_model
    rng = np.random.default_rng(12)
    idx = torch.from_numpy(np.stack([rng.choice(tcfg.num_experts, k,
                                                replace=False)
                                     for _ in range(t)])).long()
    tok, _, _, _, order = tmoe.build_dispatch(
        idx, t, tmoe.capacity(t, tcfg), tcfg)
    x = torch.from_numpy(rng.standard_normal((t, d)).astype(np.float32))
    cot = torch.from_numpy(rng.integers(-4, 5, (t * k, d)).astype(
        np.float32))
    xa = x.clone().requires_grad_()
    xb = x.clone().requires_grad_()
    ra = xa[tok]
    rb = xb.unsqueeze(1).expand(t, k, d).reshape(t * k, d)[order]
    assert torch.equal(ra, rb)
    (ra * cot).sum().backward()
    (rb * cot).sum().backward()
    assert torch.equal(xa.grad, xb.grad)
