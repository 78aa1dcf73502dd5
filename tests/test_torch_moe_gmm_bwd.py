"""Backward of the port's grouped expert matmul on the CPU: the plain
version ``moe_gmm_bwd_ref`` and the autograd Function ``MoeGmmFn`` (its
``impl="ref"`` branch) against ``jax.grad`` of the reference's oracle
(``repro.kernels.moe_gmm.ref.moe_gmm_ref``) on the same numpy inputs,
the wrapper's refusals and its choice of instance.  The CUDA kernel
itself is held against the plain version on the card
(test_torch_moe_gmm_bwd_cuda.py, chip_smoke.py).

Tolerances: fp32 atol/rtol 1e-5 (the same fp32 sums in another order);
bf16 atol 1.6e-2, rtol 1e-2 against the oracle's gradient, whose
products JAX also sums in fp32 and rounds once to bf16 (one bf16 ulp
apart at most).  With ``counts``, the oracle's output is masked past
the counts (it has no such argument), and rows of x past the counts
hold values that must add nothing to dW: dX is exact zeros there.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.moe_gmm.ref import moe_gmm_ref as jax_ref  # noqa: E402
from repro_torch.kernels.moe_gmm import moe_gmm as kmod  # noqa: E402
from repro_torch.kernels.moe_gmm import ops  # noqa: E402
from repro_torch.kernels.moe_gmm.ref import (moe_gmm_bwd_ref,  # noqa: E402
                                             moe_gmm_ref)

TOLS = {"fp32": dict(atol=1e-5, rtol=1e-5),
        "bf16": dict(atol=1.6e-2, rtol=1e-2)}
SHAPES = [
    (4, 24, 64, 44, None),
    (4, 24, 64, 44, [0, 24, 7, 1]),      # an empty expert and a full one
    (3, 5, 37, 19, [5, 2, 0]),           # nothing divides anything
    (2, 48, 88, 128, [48, 30]),          # deepseek's wi ratio / 16
    (2, 40, 128, 88, None),              # and wo's: K and F swapped
    (1, 1, 1, 1, None),
]


def _inputs(e, c, k, f, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((e, c, k)).astype(np.float32)
    w = (rng.standard_normal((e, k, f)) / np.sqrt(k)).astype(np.float32)
    dy = rng.standard_normal((e, c, f)).astype(np.float32)
    return x, w, dy


def _mask(c, counts):
    """(E, C, 1) float mask of the live rows (numpy), all ones without
    counts."""
    if counts is None:
        return None
    return (np.arange(c)[None, :] < np.asarray(counts)[:, None])[..., None]


def _jax_grads(x, w, dy, counts, dtype):
    """jax.grad of the oracle (masked past the counts) at x, w for the
    cotangent dy, in fp32."""
    jt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    m = _mask(x.shape[1], counts)

    def f(xx, ww):
        out = jax_ref(xx, ww)
        if m is not None:
            out = jnp.where(jnp.asarray(m), out, 0)
        return out

    _, vjp = jax.vjp(f, jnp.asarray(x, jt), jnp.asarray(w, jt))
    dx, dw = vjp(jnp.asarray(dy, jt))
    return (np.asarray(dx.astype(jnp.float32)),
            np.asarray(dw.astype(jnp.float32)))


def _torch(dtype, *arrs):
    tt = torch.bfloat16 if dtype == "bf16" else torch.float32
    return [torch.from_numpy(a).to(tt) for a in arrs]


def _counts(counts):
    return None if counts is None else torch.tensor(counts,
                                                    dtype=torch.int32)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("e,c,k,f,counts", SHAPES)
def test_plain_backward_matches_jax_grad_of_the_oracle(e, c, k, f, counts,
                                                       dtype):
    x, w, dy = _inputs(e, c, k, f, seed=e * 7 + c + k + f)
    jdx, jdw = _jax_grads(x, w, dy, counts, dtype)
    tx, tw, tdy = _torch(dtype, x, w, dy)
    dx, dw = moe_gmm_bwd_ref(tx, tw, tdy, _counts(counts))
    assert dx.dtype == tx.dtype and tuple(dx.shape) == (e, c, k)
    assert dw.dtype == tw.dtype and tuple(dw.shape) == (e, k, f)
    np.testing.assert_allclose(dx.float().numpy(), jdx, **TOLS[dtype])
    np.testing.assert_allclose(dw.float().numpy(), jdw, **TOLS[dtype])


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("e,c,k,f,counts", SHAPES)
def test_function_gradients_match_jax_grad_of_the_oracle(e, c, k, f, counts,
                                                         dtype):
    """``moe_gmm(..., impl="ref")`` under autograd goes through
    ``MoeGmmFn``; its x and w gradients are the oracle's."""
    x, w, dy = _inputs(e, c, k, f, seed=e * 5 + c + k + f)
    jdx, jdw = _jax_grads(x, w, dy, counts, dtype)
    tx, tw, tdy = _torch(dtype, x, w, dy)
    tx.requires_grad_()
    tw.requires_grad_()
    out = ops.moe_gmm(tx, tw, _counts(counts), impl="ref")
    assert "MoeGmmFn" in type(out.grad_fn).__name__
    assert torch.equal(out.detach(), moe_gmm_ref(tx.detach(), tw.detach(),
                                                 _counts(counts)))
    out.backward(tdy)
    np.testing.assert_allclose(tx.grad.float().numpy(), jdx, **TOLS[dtype])
    np.testing.assert_allclose(tw.grad.float().numpy(), jdw, **TOLS[dtype])


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_rows_past_counts_give_zero_dx_and_no_share_of_dw(dtype):
    """Rows of x and dy past the counts hold values: dX is exactly zero
    there, and dW equals the one computed with those rows zeroed."""
    e, c, k, f = 3, 16, 24, 40
    counts = [16, 5, 0]
    x, w, dy = _inputs(e, c, k, f, seed=11)
    m = _mask(c, counts)
    tx, tw, tdy = _torch(dtype, x, w, dy)
    txz, _, tdyz = _torch(dtype, x * m, w, dy * m)
    cn = _counts(counts)
    dx, dw = moe_gmm_bwd_ref(tx, tw, tdy, cn)
    dxz, dwz = moe_gmm_bwd_ref(txz, tw, tdyz, cn)
    for i, n in enumerate(counts):
        assert bool((dx[i, n:] == 0).all())
    assert bool((dw[2] == 0).all())                    # the empty expert
    assert torch.equal(dx, dxz) and torch.equal(dw, dwz)
    full_dx, full_dw = moe_gmm_bwd_ref(txz, tw, tdyz)
    assert torch.equal(dx, full_dx) and torch.equal(dw, full_dw)


def test_no_function_without_autograd():
    """The serving paths (grad disabled, or no input requiring grad) run
    the forward alone: no graph node, the plain version's bits."""
    x, w, _ = (torch.from_numpy(a) for a in _inputs(2, 7, 9, 5, seed=1))
    out = ops.moe_gmm(x, w)
    assert out.grad_fn is None and torch.equal(out, moe_gmm_ref(x, w))
    w.requires_grad_()
    with torch.no_grad():
        assert ops.moe_gmm(x, w).grad_fn is None


def test_backward_kernel_refuses_cpu_tensors():
    x, w, dy = (torch.from_numpy(a) for a in _inputs(2, 8, 16, 8, seed=2))
    with pytest.raises(ValueError, match="CUDA"):
        kmod.moe_gmm_bwd(x, w, dy)
    x.requires_grad_()
    with pytest.raises(ValueError, match="CUDA"):
        ops.moe_gmm(x, w, impl="kernel")
    assert kmod.LAUNCHES_BWD == 0 and kmod.LAUNCHES_BWD_TC == 0


@pytest.mark.parametrize("impl", ["auto", "ref"])
def test_plain_backward_refuses_bad_counts(impl):
    x, w, dy = (torch.from_numpy(a) for a in _inputs(4, 8, 16, 8, seed=3))
    with pytest.raises(ValueError, match="counts"):
        moe_gmm_bwd_ref(x, w, dy, torch.full((3,), 8, dtype=torch.int32))
    x.requires_grad_()
    with pytest.raises(ValueError, match="counts"):
        ops.moe_gmm(x, w, torch.full((4,), 8, dtype=torch.int64), impl=impl)


def test_bwd_instance_choice():
    """bf16 x, w and dy with K and F multiples of 8 (deepseek-moe-16b's
    wi / wg (2048, 1408) and wo (1408, 2048) products at the training
    capacity 960) take the tensor-core instance; fp32, a ragged F, a
    misaligned dy or one fp32 operand take the CUDA-core one."""
    bf = torch.bfloat16

    def pick(k, f, dtype=bf, offset=0, dy_dtype=None):
        e, c = 2, 3
        dy = torch.zeros(e * c * f + offset, dtype=dy_dtype or dtype)
        return kmod.bwd_instance(torch.zeros((e, c, k), dtype=dtype),
                                 torch.zeros((e, k, f), dtype=dtype),
                                 dy[offset:].view(e, c, f))

    assert pick(2048, 1408) == "tc" and pick(1408, 2048) == "tc"
    assert pick(64, 48) == "tc"
    assert pick(64, 44) == "cuda_core"
    assert pick(2048, 1408, torch.float32) == "cuda_core"
    assert pick(2048, 1408, offset=1) == "cuda_core"
    assert pick(2048, 1408, dy_dtype=torch.float32) == "cuda_core"


def test_every_kernel_source_is_built():
    """``kernels/_build.py`` builds every ``csrc/*.cu``, the backward's
    source included, so ``chip_smoke.py``'s one build covers it."""
    from repro_torch.kernels import _build

    sources = {p.stem for p in _build.CSRC.glob("*.cu")}
    assert "moe_gmm_bwd" in sources
    assert set(_build.KERNELS) == sources
