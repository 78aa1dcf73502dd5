"""RG-LRU of the port against the reference, on the same numpy inputs:

* the scan kernel's plain version against the Pallas kernel in interpret
  mode and against the reference's oracle (an associative scan), and with
  an initial state against the reference model's ``rglru_scan`` (state in
  and out, including its 256-token chunked path);
* ``causal_conv1d`` (prefill and one-step forms), ``rglru_step`` and
  ``recurrent_block`` (prefill, then decode steps on the carried state)
  against ``repro.models.rglru``.

The CUDA kernel itself is held against the plain version on the card
(test_torch_kernels_cuda.py, chip_smoke.py).  Tolerance: atol/rtol 1e-5
for the scan (the same fp32 recurrence; the reference's associative scan
multiplies in another order), 1e-5 for the block (fp32 matmuls in another
summation order).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke as jsmoke  # noqa: E402
from repro.kernels.rglru_scan.ops import rglru_scan as pallas_scan  # noqa: E402
from repro.kernels.rglru_scan.ref import rglru_scan_ref as jax_ref  # noqa: E402
from repro.models import init as jinit  # noqa: E402
from repro.models import rglru as jrg  # noqa: E402
from repro_torch.configs import get_smoke as tsmoke  # noqa: E402
from repro_torch.kernels.rglru_scan import rglru_scan as kmod  # noqa: E402
from repro_torch.kernels.rglru_scan.ops import rglru_scan  # noqa: E402
from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref  # noqa: E402
from repro_torch.models import rglru as trg  # noqa: E402
from repro_torch.models.init import params_from_numpy  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)


def _ab(b, s, c, seed):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.85, 0.999, (b, s, c)).astype(np.float32)
    x = (0.1 * rng.standard_normal((b, s, c))).astype(np.float32)
    return a, x


@pytest.mark.parametrize("b,s,c,bs_,bc", [
    (1, 64, 32, 32, 32), (3, 48, 16, 16, 16)])
def test_plain_matches_pallas_kernel_interpret(b, s, c, bs_, bc):
    a, x = _ab(b, s, c, seed=s + c)
    ref = np.asarray(pallas_scan(jnp.asarray(a), jnp.asarray(x), block_s=bs_,
                                 block_c=bc, interpret=True))
    out = rglru_scan(torch.from_numpy(a), torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), ref, **TOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(
        jax_ref(jnp.asarray(a), jnp.asarray(x))), **TOL)


def test_plain_bf16_rounds_each_output_once():
    """bf16 inputs: the carry stays fp32, each output is rounded once."""
    a, x = _ab(2, 40, 16, seed=3)
    ta = torch.from_numpy(a).to(torch.bfloat16)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    out = rglru_scan_ref(ta, tx)
    want = rglru_scan_ref(ta.float(), tx.float()).to(torch.bfloat16)
    assert out.dtype == torch.bfloat16
    assert torch.equal(out, want)


def _rec_params(seed=0):
    jcfg, tcfg = jsmoke("recurrentgemma-2b"), tsmoke("recurrentgemma-2b")
    jp = jinit.init_params(jcfg, jax.random.key(seed))["layers"]["0"]["rec"]
    # non-zero biases so every term of the gates is exercised
    rng = np.random.default_rng(seed)
    jp = {**jp, **{k: jnp.asarray(0.1 * rng.standard_normal(jp[k].shape),
                                  jnp.float32)
                   for k in ("lru_ba", "lru_bx", "conv_b")}}
    return jcfg, tcfg, jp, params_from_numpy(jax.tree.map(np.asarray, jp),
                                             "cpu")


@pytest.mark.parametrize("s", [37, 512])
def test_scan_with_state_matches_model_function(s):
    """State in and out: the port's rglru_scan (plain scan) from h0
    against the reference model's, which takes one associative scan at 37
    tokens and the 256-token chunked scan at 512."""
    jcfg, _, jp, tp = _rec_params()
    rng = np.random.default_rng(s)
    x = rng.standard_normal((2, s, jcfg.lru_width)).astype(np.float32)
    h0 = rng.standard_normal((2, jcfg.lru_width)).astype(np.float32)
    jy, jh = jax.jit(jrg.rglru_scan)(jnp.asarray(x), jp, jnp.asarray(h0))
    ty, th = trg.rglru_scan(torch.from_numpy(x), tp, torch.from_numpy(h0))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
    assert th.dtype == torch.float32


def test_causal_conv1d_both_forms_match_reference():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 9, 8)).astype(np.float32)
    w = rng.standard_normal((4, 8)).astype(np.float32)
    b = rng.standard_normal((8,)).astype(np.float32)
    for seq in (9, 2):              # shorter than the window: padded state
        jy, js = jrg.causal_conv1d(jnp.asarray(x[:, :seq]), jnp.asarray(w),
                                   jnp.asarray(b))
        ty, ts = trg.causal_conv1d(torch.from_numpy(x[:, :seq]),
                                   torch.from_numpy(w), torch.from_numpy(b))
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    state = rng.standard_normal((2, 3, 8)).astype(np.float32)
    jy, js = jrg.causal_conv1d(jnp.asarray(x[:, :1]), jnp.asarray(w),
                               jnp.asarray(b), jnp.asarray(state))
    ty, ts = trg.causal_conv1d(torch.from_numpy(x[:, :1]),
                               torch.from_numpy(w), torch.from_numpy(b),
                               torch.from_numpy(state))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_recurrent_block_prefill_then_steps_match_reference():
    jcfg, tcfg, jp, tp = _rec_params(seed=1)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 20, jcfg.d_model)).astype(np.float32)
    block = jax.jit(lambda x, p, st: jrg.recurrent_block(x, p, jcfg, st))
    jy, jst = block(jnp.asarray(x), jp, None)
    ty, tst = trg.recurrent_block(torch.from_numpy(x), tp, tcfg)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    for _ in range(4):
        xt = rng.standard_normal((2, 1, jcfg.d_model)).astype(np.float32)
        jy, jst = block(jnp.asarray(xt), jp, jst)
        ty, tst = trg.recurrent_block(torch.from_numpy(xt), tp, tcfg, tst)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
        np.testing.assert_allclose(tst["conv"].numpy(),
                                   np.asarray(jst["conv"]), **TOL)
        np.testing.assert_allclose(tst["h"].numpy(), np.asarray(jst["h"]),
                                   **TOL)
        assert tst["h"].dtype == torch.float32


def test_softplus_is_logaddexp_not_thresholded():
    x = torch.tensor([-30.0, 0.0, 19.0, 25.0, 40.0])
    want = np.asarray(jax.nn.softplus(jnp.asarray(x.numpy())))
    np.testing.assert_allclose(trg._softplus(x).numpy(), want, rtol=1e-7)


def test_auto_on_cpu_is_the_plain_version():
    a, x = (torch.from_numpy(t) for t in _ab(1, 7, 5, seed=1))
    h0 = torch.ones((1, 5))
    assert torch.equal(rglru_scan(a, x, h0, impl="auto"),
                       rglru_scan_ref(a, x, h0))
    with pytest.raises(ValueError, match="unknown kernel impl"):
        rglru_scan(a, x, impl="fast")


def test_kernel_refuses_cpu_tensors():
    a, x = (torch.from_numpy(t) for t in _ab(1, 7, 5, seed=2))
    with pytest.raises(ValueError, match="CUDA"):
        rglru_scan(a, x, impl="kernel")
    assert kmod.LAUNCHES == 0
