"""The port's ring collective matmul (``repro_torch.parallel.overlap``)
on 4 gloo ranks, a (2, 2) ("data", "model") mesh: ``ring_allgather_
matmul`` against ``plain_allgather_matmul``, x @ w in fp32 and the
reference's ``ring_allgather_matmul`` on a 4-device CPU mesh of Auto
axes (TOL), over the model axis and over the data axis; the counter sees
one collective-permute per ring step (n_dev = 2 a call) and the plain
lowering's all-gather."""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tests._torch_mesh import auto_mesh, run_reference, save, spawn  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)
AXES = ("model", "data")
M, K, N = 8, 12, 6


def _operands():
    rng = np.random.default_rng(11)
    return (rng.standard_normal((M, K)).astype(np.float32),
            rng.standard_normal((K, N)).astype(np.float32))


def reference(out):
    import jax

    from repro.parallel.overlap import ring_allgather_matmul

    mesh = auto_mesh()
    x, w = _operands()
    save({axis: np.asarray(jax.jit(
        lambda a, b, axis=axis: ring_allgather_matmul(a, b, mesh, axis))(
            x, w)) for axis in AXES}, out)


def port(rank, mesh):
    from torch.distributed.tensor import Replicate

    from repro_torch.core.collectives import CollectiveCounter
    from repro_torch.parallel.overlap import (plain_allgather_matmul,
                                              ring_allgather_matmul)
    from repro_torch.parallel.sharding import distribute

    x, w = (torch.from_numpy(a) for a in _operands())
    rep = (Replicate(),) * mesh.ndim
    res = {}
    for axis in AXES:
        xd, wd = distribute(x, rep, mesh), distribute(w, rep, mesh)
        ring_c, plain_c = CollectiveCounter(), CollectiveCounter()
        with ring_c:
            ring = ring_allgather_matmul(xd, wd, mesh, axis)
        with plain_c:
            plain = plain_allgather_matmul(xd, wd, mesh, axis)
        res[axis] = {"ring": ring.full_tensor().numpy(),
                     "plain": plain.full_tensor().numpy(),
                     "ring_kinds": ring_c.stats().count_by_kind,
                     "plain_kinds": plain_c.stats().count_by_kind,
                     "placements": [str(p) for p in ring.placements]}
    return res


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("overlap")
    ref = run_reference("test_torch_overlap", "reference", tmp / "ref.pkl")
    return ref, spawn(port, tmp / "port")


@pytest.mark.parametrize("axis", AXES)
def test_ring_matches_plain_product_and_reference(results, axis):
    ref, ranks = results
    x, w = _operands()
    for r in ranks:
        got = r[axis]
        np.testing.assert_allclose(got["ring"], got["plain"], **TOL)
        np.testing.assert_allclose(got["ring"], x @ w, **TOL)
        np.testing.assert_allclose(got["ring"], ref[axis], **TOL)


@pytest.mark.parametrize("axis", AXES)
def test_ring_sends_once_a_step(results, axis):
    _, ranks = results
    got = ranks[0][axis]
    assert got["ring_kinds"].get("collective-permute") == 2
    want = ["S(1)" if name == axis else "R"
            for name in ("data", "model")]
    assert got["placements"] == want
    assert got["plain_kinds"].get("all-gather", 0) >= 1
    assert "collective-permute" not in got["plain_kinds"]
