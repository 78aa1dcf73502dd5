"""RWKV-6 of the port against the reference, on the same numpy inputs:

* the WKV kernel's plain version against the Pallas kernel in interpret
  mode (whole 64-token chunks, the only lengths it takes) and against the
  reference's fp64 oracle on ragged lengths, also at the model's full
  decay range, and, with an initial state,
  against the reference model's ``wkv_scan`` / ``wkv_chunked`` (final
  state included);
* ``time_mix`` (prefill at 40 tokens, the reference's per-token scan, and
  at 128, its chunked form; then decode steps on the carried state) and
  ``channel_mix`` against ``repro.models.rwkv``.

The CUDA kernel itself is held against the plain version on the card
(test_torch_kernels_cuda.py, chip_smoke.py).  Tolerance: atol/rtol 1e-4
(the acceptance bound: the chunked forms sum exp-weighted products in
another order than the per-token recurrence).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke as jsmoke  # noqa: E402
from repro.kernels.rwkv6_wkv.ops import rwkv6_wkv as pallas_wkv  # noqa: E402
from repro.kernels.rwkv6_wkv.ref import wkv_ref  # noqa: E402
from repro.models import init as jinit  # noqa: E402
from repro.models import rwkv as jrw  # noqa: E402
from repro_torch.configs import get_smoke as tsmoke  # noqa: E402
from repro_torch.kernels.rwkv6_wkv import rwkv6_wkv as kmod  # noqa: E402
from repro_torch.kernels.rwkv6_wkv.ops import rwkv6_wkv  # noqa: E402
from repro_torch.kernels.rwkv6_wkv.ref import rwkv6_wkv_ref  # noqa: E402
from repro_torch.models import rwkv as trw  # noqa: E402
from repro_torch.models.init import params_from_numpy  # noqa: E402

TOL = dict(atol=1e-4, rtol=1e-4)


def _inputs(b, s, h, n, seed):
    """r, k, v, logw (b, s, h, n) and u (h, n), the reference tests' scales."""
    rng = np.random.default_rng(seed)
    r, k, v = (0.5 * rng.standard_normal((b, s, h, n)) for _ in range(3))
    logw = -np.exp(0.5 * rng.standard_normal((b, s, h, n)))
    u = 0.5 * rng.standard_normal((h, n))
    return [a.astype(np.float32) for a in (r, k, v, logw, u)]


def _bhsn(a):
    return jnp.asarray(a.transpose(0, 2, 1, 3))


@pytest.mark.parametrize("b,s,h,n", [(1, 128, 2, 16), (2, 64, 1, 32)])
def test_plain_matches_pallas_kernel_interpret(b, s, h, n):
    r, k, v, logw, u = _inputs(b, s, h, n, seed=s + n)
    ref = np.asarray(pallas_wkv(_bhsn(r), _bhsn(k), _bhsn(v), _bhsn(logw),
                                jnp.asarray(u), chunk=64, interpret=True))
    o, _ = rwkv6_wkv(*(torch.from_numpy(a) for a in (r, k, v, logw, u)))
    np.testing.assert_allclose(o.numpy().transpose(0, 2, 1, 3), ref, **TOL)


@pytest.mark.parametrize("s", [1, 40, 77])
def test_plain_matches_reference_oracle_ragged(s):
    r, k, v, logw, u = _inputs(2, s, 2, 16, seed=s)
    ref = np.asarray(wkv_ref(_bhsn(r), _bhsn(k), _bhsn(v), _bhsn(logw), u))
    o, _ = rwkv6_wkv(*(torch.from_numpy(a) for a in (r, k, v, logw, u)))
    np.testing.assert_allclose(o.numpy().transpose(0, 2, 1, 3), ref, **TOL)


@pytest.mark.parametrize("s", [1, 45, 77])
def test_plain_matches_reference_oracle_full_decay_range(s):
    """At the decays the model allows (logw = -exp(d), d in [-20, 10]:
    the clamp of ``time_mix``), w runs from 1 - 2e-9 to 0; the per-token
    plain version stays within the tolerance of the fp64 oracle.  (The
    Pallas chunked form does not at this range: it subtracts cumulative
    log-decay sums of ~1e6 in fp32.)"""
    r, k, v, _, u = _inputs(2, s, 2, 16, seed=100 + s)
    d = np.random.default_rng(s).uniform(-20.0, 10.0, r.shape)
    logw = (-np.exp(d)).astype(np.float32)
    ref = np.asarray(wkv_ref(_bhsn(r), _bhsn(k), _bhsn(v), _bhsn(logw), u))
    o, _ = rwkv6_wkv(*(torch.from_numpy(a) for a in (r, k, v, logw, u)))
    np.testing.assert_allclose(o.numpy().transpose(0, 2, 1, 3), ref, **TOL)


@pytest.mark.parametrize("s", [40, 128])
def test_state_in_and_out_matches_model_functions(s):
    """From a nonzero state: the output and the final state against the
    reference's wkv_chunked (which takes its per-token scan at 40 and the
    chunked form at 128)."""
    r, k, v, logw, u = _inputs(1, s, 2, 16, seed=7 + s)
    s0 = np.random.default_rng(s).standard_normal((1, 2, 16, 16)) \
        .astype(np.float32)
    jo, js = jax.jit(lambda *a: jrw.wkv_chunked(*a, chunk=64))(
        *(jnp.asarray(a) for a in (r, k, v, logw, u, s0)))
    to, ts = rwkv6_wkv(*(torch.from_numpy(a) for a in (r, k, v, logw, u)),
                       torch.from_numpy(s0))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **TOL)
    # one more token through the model's decode step continues the state
    jo1, js1 = jrw.wkv_step(*(jnp.asarray(a[:, -1]) for a in (r, k, v)),
                            jnp.exp(jnp.asarray(logw[:, -1])),
                            jnp.asarray(u), js)
    to1, ts1 = trw.wkv_step(*(torch.from_numpy(a[:, -1]) for a in (r, k, v)),
                            torch.exp(torch.from_numpy(logw[:, -1])),
                            torch.from_numpy(u), ts)
    np.testing.assert_allclose(to1.numpy(), np.asarray(jo1), **TOL)
    np.testing.assert_allclose(ts1.numpy(), np.asarray(js1), **TOL)


def _block_params():
    jcfg, tcfg = jsmoke("rwkv6-3b"), tsmoke("rwkv6-3b")
    jp = jinit.init_params(jcfg, jax.random.key(0))["blocks"]
    jp = jax.tree.map(lambda a: a[0], jp)
    # decay_b is zero-initialised: give the data-dependent decay some work
    rng = np.random.default_rng(0)
    tm = dict(jp["tm"])
    tm["decay_b"] = jnp.asarray(0.1 * rng.standard_normal(
        tm["decay_b"].shape), jnp.float32)
    jp = {**jp, "tm": tm}
    return jcfg, tcfg, jp, params_from_numpy(jax.tree.map(np.asarray, jp),
                                             "cpu")


@pytest.mark.parametrize("s", [40, 128])
def test_time_and_channel_mix_prefill_then_steps_match_reference(s):
    jcfg, tcfg, jp, tp = _block_params()
    rng = np.random.default_rng(s)
    x = rng.standard_normal((1, s, jcfg.d_model)).astype(np.float32)
    tmix = jax.jit(lambda x, p, st: jrw.time_mix(x, p, jcfg, st))
    cmix = jax.jit(lambda x, p, st: jrw.channel_mix(x, p, jcfg, st))
    jy, jst = tmix(jnp.asarray(x), jp["tm"], None)
    ty, tst = trw.time_mix(torch.from_numpy(x), tp["tm"], tcfg)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(tst["s"].numpy(), np.asarray(jst["s"]), **TOL)
    jc, jcst = cmix(jnp.asarray(x), jp["cm"], None)
    tc, tcst = trw.channel_mix(torch.from_numpy(x), tp["cm"], tcfg)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **TOL)
    for _ in range(3):
        xt = rng.standard_normal((1, 1, jcfg.d_model)).astype(np.float32)
        jy, jst = tmix(jnp.asarray(xt), jp["tm"], jst)
        ty, tst = trw.time_mix(torch.from_numpy(xt), tp["tm"], tcfg, tst)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
        np.testing.assert_allclose(tst["s"].numpy(), np.asarray(jst["s"]),
                                   **TOL)
        np.testing.assert_array_equal(tst["last"].numpy(),
                                      np.asarray(jst["last"]))
        jc, jcst = cmix(jnp.asarray(xt), jp["cm"], jcst)
        tc, tcst = trw.channel_mix(torch.from_numpy(xt), tp["cm"], tcfg,
                                   tcst)
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **TOL)


def test_group_norm_matches_reference():
    x = np.random.default_rng(1).standard_normal((2, 5, 64)) \
        .astype(np.float32)
    w = np.linspace(0.5, 1.5, 64, dtype=np.float32)
    np.testing.assert_allclose(
        trw._group_norm(torch.from_numpy(x), torch.from_numpy(w), 4).numpy(),
        np.asarray(jrw._group_norm(jnp.asarray(x), jnp.asarray(w), 4)),
        atol=1e-5, rtol=1e-5)


def test_auto_on_cpu_is_the_plain_version():
    args = [torch.from_numpy(a) for a in _inputs(1, 9, 2, 16, seed=3)]
    o, st = rwkv6_wkv(*args, impl="auto")
    o_ref, st_ref = rwkv6_wkv_ref(*args)
    assert torch.equal(o, o_ref) and torch.equal(st, st_ref)
    with pytest.raises(ValueError, match="unknown kernel impl"):
        rwkv6_wkv(*args, impl="fast")


def test_kernel_refuses_cpu_tensors():
    args = [torch.from_numpy(a) for a in _inputs(1, 9, 2, 16, seed=4)]
    with pytest.raises(ValueError, match="CUDA"):
        rwkv6_wkv(*args, impl="kernel")
    assert kmod.LAUNCHES == 0
