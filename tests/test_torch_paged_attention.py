"""Paged attention of the port: its plain version against the reference's
oracle (``paged_attention_ref``) and the Pallas kernel in interpret mode,
on the same numpy inputs in fp32.  Covers mixed lengths including 0
(exact zeros), GQA with g=3, sliding windows, shuffled page order and
tables whose tail names a null page, and rows of 16 pages; then the
wrapper's split planner.  The CUDA kernel itself is held
against the plain version on the card (test_torch_kernels_cuda.py,
chip_smoke.py).

Tolerance 1e-5 (atol and rtol): the same fp32 arithmetic in another
summation order.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.paged_attention.paged_attention import \
    paged_attention as pallas_paged  # noqa: E402
from repro.kernels.paged_attention.ref import \
    paged_attention_ref as jax_ref  # noqa: E402
from repro_torch.kernels.paged_attention import \
    paged_attention as kmod  # noqa: E402
from repro_torch.kernels.paged_attention.ops import \
    paged_attention_decode  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)

# (b, hq, hkv, d, block_tokens, nb, window, lengths)
CASES = [
    (4, 3, 1, 16, 16, 3, 0, [48, 0, 17, 1]),        # g=3, an inactive row
    (3, 9, 3, 16, 16, 4, 0, [33, 64, 5]),           # smollm's head ratio
    (4, 6, 3, 32, 8, 4, 6, [0, 12, 32, 7]),         # window inside a page
    (3, 4, 1, 16, 8, 4, 20, [31, 9, 0]),            # window across pages
    (2, 3, 1, 64, 128, 3, 0, [200, 129]),           # 128-token pages, d=64
    (3, 3, 1, 16, 16, 16, 0, [250, 0, 97]),         # 16 pages a row
    (3, 6, 2, 32, 16, 16, 70, [250, 40, 129]),      # window over 5-6 pages
]


def _inputs(b, hq, hkv, d, bt, nb, lengths, seed):
    """Shuffled distinct pages per row; entries past a row's length name
    the null page (the last one), as the batched executor's tables do."""
    rng = np.random.default_rng(seed)
    n_pages = b * nb + 1
    null = n_pages - 1
    q = rng.standard_normal((b, hq, d)).astype(np.float32)
    kp = rng.standard_normal((hkv, n_pages, bt, d)).astype(np.float32)
    vp = rng.standard_normal((hkv, n_pages, bt, d)).astype(np.float32)
    tables = rng.permutation(b * nb).reshape(b, nb).astype(np.int32)
    for r, n in enumerate(lengths):
        tables[r, -(-n // bt):] = null
    return q, kp, vp, tables, np.asarray(lengths, np.int32)


def _port(arrs, window):
    return paged_attention_decode(*(torch.from_numpy(a) for a in arrs),
                                  window=window).numpy()


@pytest.mark.parametrize("b,hq,hkv,d,bt,nb,window,lengths", CASES)
def test_plain_matches_reference_oracle(b, hq, hkv, d, bt, nb, window,
                                        lengths):
    arrs = _inputs(b, hq, hkv, d, bt, nb, lengths, seed=b * d + bt)
    ref = np.asarray(jax_ref(*(jnp.asarray(a) for a in arrs), window=window))
    np.testing.assert_allclose(_port(arrs, window), ref, **TOL)


@pytest.mark.parametrize("b,hq,hkv,d,bt,nb,window,lengths", CASES)
def test_plain_matches_pallas_kernel_interpret(b, hq, hkv, d, bt, nb, window,
                                               lengths):
    arrs = _inputs(b, hq, hkv, d, bt, nb, lengths, seed=b * d + bt + 1)
    ref = np.asarray(pallas_paged(*(jnp.asarray(a) for a in arrs),
                                  window=window, interpret=True))
    np.testing.assert_allclose(_port(arrs, window), ref, **TOL)


def test_inactive_rows_are_exact_zeros():
    arrs = _inputs(4, 3, 1, 16, 8, 3, [0, 5, 0, 17], seed=3)
    out = _port(arrs, window=0)
    assert np.all(out[[0, 2]] == 0.0)
    assert np.all(np.isfinite(out))


def test_kernel_refuses_cpu_tensors():
    arrs = [torch.from_numpy(a)
            for a in _inputs(2, 3, 1, 64, 8, 2, [3, 9], seed=4)]
    with pytest.raises(ValueError, match="CUDA"):
        paged_attention_decode(*arrs, impl="kernel")
    assert kmod.LAUNCHES == 0


@pytest.mark.parametrize("b,hkv,nb,pps", [
    (8, 3, 3, 1),        # smollm-135m's serving width: 72 blocks
    (8, 16, 3, 1),       # deepseek-moe-16b's: 384
    (8, 3, 16, 1),       # smollm at 16 pages: 384
    (8, 16, 16, 2),      # deepseek at 16 pages: 2,048 -> 1,024 blocks
    (16, 16, 64, 16),    # 16,384 one-page blocks -> 1,024
    (1, 1, 1, 1),
    (2000, 1, 5, 5),     # no split can hold more than the whole table
])
def test_plan_splits(b, hkv, nb, pps):
    assert kmod.plan_splits(b, hkv, nb) == pps
    n_splits = -(-nb // pps)
    assert b * hkv * n_splits <= kmod.MAX_BLOCKS or pps == nb


def test_workspace_only_when_a_row_can_span_splits():
    g, d = 3, 64
    assert kmod.workspace_floats(8, 3, g, d, 3, 3) == 0
    assert kmod.workspace_floats(8, 3, g, d, 1, 1) == 0
    # one (acc[g x d], max[g], sum[g]) record per split, row and kv head
    assert kmod.workspace_floats(8, 3, g, d, 16, 1) == 8 * 3 * 16 * (
        g * d + 2 * g)
    assert kmod.workspace_floats(8, 16, 1, 128, 16, 2) == 8 * 16 * 8 * (
        128 + 2)
