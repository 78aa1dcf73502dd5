"""Grouped expert matmul of the port: its plain version against the
reference's Pallas kernel in interpret mode (on the tile-dividing shapes
of tests/test_kernels.py) and against the reference's oracle
(``moe_gmm_ref``) on ragged shapes the Pallas kernel cannot take, in fp32
and bf16, on the same numpy inputs; with ``counts`` (rows past them zero)
against the oracle, which has no such argument.  The wrapper's choice of
instance and its checks of ``counts`` are pinned here; the CUDA kernel
itself is held against the plain version on the card
(test_torch_kernels_cuda.py, chip_smoke.py).

Tolerances: fp32 atol/rtol 1e-5 (the same fp32 sums in another order);
bf16 atol 1.6e-2, rtol 1e-2 — both sides sum in fp32 and round once to
bf16, so they differ by at most one bf16 ulp.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.moe_gmm.ops import moe_gmm as pallas_gmm  # noqa: E402
from repro.kernels.moe_gmm.ref import moe_gmm_ref as jax_ref  # noqa: E402
from repro_torch.kernels.moe_gmm import moe_gmm as kmod  # noqa: E402
from repro_torch.kernels.moe_gmm.ops import moe_gmm  # noqa: E402
from repro_torch.kernels.moe_gmm.ref import moe_gmm_ref  # noqa: E402

TOLS = {"fp32": dict(atol=1e-5, rtol=1e-5),
        "bf16": dict(atol=1.6e-2, rtol=1e-2)}


def _inputs(e, c, k, f, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((e, c, k)).astype(np.float32)
    w = (rng.standard_normal((e, k, f)) / np.sqrt(k)).astype(np.float32)
    return x, w


def _as(dtype, *arrs):
    if dtype == "bf16":
        return ([jnp.asarray(a, jnp.bfloat16) for a in arrs],
                [torch.from_numpy(a).to(torch.bfloat16) for a in arrs])
    return [jnp.asarray(a) for a in arrs], [torch.from_numpy(a) for a in arrs]


@pytest.mark.parametrize("e,c,k,f", [
    (4, 32, 64, 48), (2, 64, 128, 64), (8, 16, 32, 32), (1, 128, 256, 128),
])
def test_plain_matches_pallas_kernel_interpret(e, c, k, f):
    x, w = _inputs(e, c, k, f, seed=e * c)
    (jx, jw), (tx, tw) = _as("fp32", x, w)
    ref = np.asarray(pallas_gmm(jx, jw, block_c=16, block_f=16, block_k=32,
                                interpret=True))
    np.testing.assert_allclose(moe_gmm(tx, tw).numpy(), ref, **TOLS["fp32"])


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("e,c,k,f", [
    (4, 24, 64, 44),        # the ragged shape of the issue
    (3, 5, 37, 19),         # nothing divides anything
    (2, 48, 88, 128),       # deepseek's decode capacity, K = 1408 / 16
    (1, 1, 1, 1),
])
def test_plain_matches_reference_oracle_ragged(e, c, k, f, dtype):
    x, w = _inputs(e, c, k, f, seed=e + c + k + f)
    (jx, jw), (tx, tw) = _as(dtype, x, w)
    ref = np.asarray(jax_ref(jx, jw).astype(jnp.float32))
    out = moe_gmm(tx, tw)
    assert out.dtype == tx.dtype and tuple(out.shape) == (e, c, f)
    np.testing.assert_allclose(out.float().numpy(), ref, **TOLS[dtype])


def test_auto_on_cpu_is_the_plain_version():
    x, w = (torch.from_numpy(a) for a in _inputs(2, 7, 9, 5, seed=1))
    assert torch.equal(moe_gmm(x, w, impl="auto"), moe_gmm_ref(x, w))
    assert torch.equal(moe_gmm(x, w, impl="ref"), moe_gmm_ref(x, w))
    with pytest.raises(ValueError, match="unknown kernel impl"):
        moe_gmm(x, w, impl="fast")


def test_kernel_refuses_cpu_tensors():
    x, w = (torch.from_numpy(a) for a in _inputs(2, 8, 16, 8, seed=2))
    with pytest.raises(ValueError, match="CUDA"):
        moe_gmm(x, w, impl="kernel")
    assert kmod.LAUNCHES == 0 and kmod.LAUNCHES_TC == 0


def _zero_past(x, counts):
    """x with rows [counts[e], C) of each expert zeroed (numpy)."""
    x = x.copy()
    for e, n in enumerate(counts):
        x[e, n:] = 0.0
    return x


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("e,c,k,f,counts", [
    (4, 24, 64, 44, [0, 24, 7, 1]),     # an empty expert and a full one
    (3, 48, 88, 128, [48, 0, 30]),
    (2, 5, 37, 19, [5, 5]),
])
def test_plain_with_counts_matches_reference_oracle(e, c, k, f, counts,
                                                    dtype):
    """With ``counts``, the plain version on inputs whose rows past the
    counts are zero equals the reference's oracle (which has no such
    argument) and its own result without counts; those rows are zeros."""
    x, w = _inputs(e, c, k, f, seed=e * k + f)
    x = _zero_past(x, counts)
    (jx, jw), (tx, tw) = _as(dtype, x, w)
    tc = torch.tensor(counts, dtype=torch.int32)
    out = moe_gmm(tx, tw, tc)
    ref = np.asarray(jax_ref(jx, jw).astype(jnp.float32))
    np.testing.assert_allclose(out.float().numpy(), ref, **TOLS[dtype])
    assert torch.equal(out, moe_gmm(tx, tw))
    assert torch.equal(out, moe_gmm_ref(tx, tw, tc))
    for i, n in enumerate(counts):
        assert bool((out[i, n:] == 0).all())


def test_counts_none_is_unchanged():
    x, w = (torch.from_numpy(a) for a in _inputs(3, 8, 16, 24, seed=4))
    ref = torch.einsum("ecd,edf->ecf", x, w)
    assert torch.equal(moe_gmm_ref(x, w, None), ref)
    assert torch.equal(moe_gmm(x, w, None), ref)


@pytest.mark.parametrize("impl", ["auto", "ref"])
@pytest.mark.parametrize("bad", ["dtype", "shape", "device"])
def test_wrapper_refuses_bad_counts(bad, impl):
    x, w = (torch.from_numpy(a) for a in _inputs(4, 8, 16, 8, seed=3))
    counts = {"dtype": torch.full((4,), 8, dtype=torch.int64),
              "shape": torch.full((3,), 8, dtype=torch.int32),
              "device": torch.full((4,), 8, dtype=torch.int32,
                                   device="meta")}[bad]
    with pytest.raises(ValueError, match="counts"):
        moe_gmm(x, w, counts, impl=impl)


def test_instance_choice():
    """bf16 products whose K and F are multiples of 8 (deepseek-moe-16b's
    (2048, 1408) and (1408, 2048)) take the tensor-core instance; fp32,
    a ragged F such as 44 and a misaligned x take the CUDA-core one."""
    bf = torch.bfloat16

    def pick(k, f, dtype=bf, offset=0):
        x = torch.zeros(2 * 3 * k + offset, dtype=dtype)[offset:]
        return kmod.instance(x.view(2, 3, k),
                             torch.zeros((2, k, f), dtype=dtype))

    assert pick(2048, 1408) == "tc" and pick(1408, 2048) == "tc"
    assert pick(64, 48) == "tc"
    assert pick(64, 44) == "cuda_core"
    assert pick(2048, 1408, torch.float32) == "cuda_core"
    assert pick(2048, 1408, offset=1) == "cuda_core"
