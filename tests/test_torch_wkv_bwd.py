"""The gradient of the port's RWKV-6 WKV against the reference's, on the
same numpy inputs in fp32:

* the plain reverse ``rwkv6_wkv_bwd_ref`` against ``jax.vjp`` of the
  reference model's per-token ``wkv_scan`` (logw through ``exp``, as
  ``wkv_chunked`` feeds it), at s 37 and 64, n 16, from zeros and from
  a nonzero s0, with cotangents on the output and on the final state;
* the same against ``jax.vjp`` of ``wkv_chunked`` at s 128 with chunk 64
  (its chunk-parallel form, two chunks) at the usual decays.  At the
  model's full decay range (logw = -exp(d), d in [-20, 10]) it is held
  to the fp64 plain reverse instead, itself held to numerical
  derivatives by ``gradcheck``: the chunked form subtracts cumulative
  log-decay sums that reach ~1e6 there and loses ~1e-2 in fp32 (the
  reference's own forward is 8.9e-3 off its oracle at that range), so
  its gradient is no yardstick there;
* ``WkvFn`` (the plain versions) through ``torch.autograd.gradcheck`` in
  float64, with and without an s0;
* ``time_mix``'s gradients, for x and every parameter, against
  ``jax.grad`` of the reference's ``time_mix`` (at 40 tokens its scan,
  at 128 its chunked form);
* what the kernel path refuses on the CPU, and that serving (no grad)
  does not go through the Function.

Tolerance: 1e-5 of each gradient's largest element plus 1e-5 relative
(``_assert_close``).  Both sides sum the same fp32 products in another
order (XLA's einsums, the scan's transposed carry); the gradients sum up
to 128 decayed outer products with terms of either sign, so an element
that cancels to a small value carries that rounding as a large relative
error, while a wrong term moves an element by the order of the largest.
The full-decay-range case is held to the fp64 reverse at 1e-5 the same
way.  The CUDA kernel is held against the plain reverse on the card
(``test_torch_wkv_bwd_cuda.py``, ``chip_smoke.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke as jsmoke  # noqa: E402
from repro.models import init as jinit  # noqa: E402
from repro.models import rwkv as jrw  # noqa: E402
from repro_torch.configs import get_smoke as tsmoke  # noqa: E402
from repro_torch.kernels.rwkv6_wkv import rwkv6_wkv as kmod  # noqa: E402
from repro_torch.kernels.rwkv6_wkv.ops import WkvFn, rwkv6_wkv  # noqa: E402
from repro_torch.kernels.rwkv6_wkv.ref import (  # noqa: E402
    rwkv6_wkv_bwd_ref, rwkv6_wkv_ref)
from repro_torch.models import rwkv as trw  # noqa: E402
from repro_torch.models.init import params_from_numpy  # noqa: E402

RTOL = 1e-5
NAMES = ("dr", "dk", "dv", "dlogw", "du", "ds0")


def _assert_close(got, want, name):
    """Within RTOL of the largest element plus RTOL relative."""
    want = np.asarray(want, dtype=np.float64)
    np.testing.assert_allclose(np.asarray(got, dtype=np.float64), want,
                               rtol=RTOL, atol=RTOL * np.abs(want).max(),
                               err_msg=name)


def _inputs(b, s, h, n, seed, decay=None):
    """r, k, v, logw, u, the output's gradient, s0 and the final state's
    gradient, at the reference tests' scales; ``decay`` (lo, hi) draws
    logw = -exp(d), d uniform in it."""
    rng = np.random.default_rng(seed)
    r, k, v = (0.5 * rng.standard_normal((b, s, h, n)) for _ in range(3))
    logw = (-np.exp(0.5 * rng.standard_normal((b, s, h, n))) if decay is None
            else -np.exp(rng.uniform(*decay, (b, s, h, n))))
    u = 0.5 * rng.standard_normal((h, n))
    do = rng.standard_normal((b, s, h, n))
    s0, ds = (rng.standard_normal((b, h, n, n)) for _ in range(2))
    return [a.astype(np.float32) for a in (r, k, v, logw, u, do, s0, ds)]


def _jax_vjp(f, r, k, v, logw, u, do, s0, ds):
    """(dr, dk, dv, dlogw, du, ds0) of the reference's ``f(r, k, v, logw,
    u, s0)`` -> (o, state) at cotangents (do, ds)."""
    args = [jnp.asarray(a) for a in (r, k, v, logw, u, s0)]
    _, vjp = jax.vjp(f, *args)
    return vjp((jnp.asarray(do), jnp.asarray(ds)))


def _scan(r, k, v, logw, u, s0):
    return jrw.wkv_scan(r, k, v, jnp.exp(logw), u, s0)


def _torch_grads(r, k, v, logw, u, do, s0, ds, with_state, dtype=None):
    t = [torch.from_numpy(a) for a in (r, k, v, logw, u, do, s0, ds)]
    if dtype is not None:
        t = [a.to(dtype) for a in t]
    r, k, v, logw, u, do, s0, ds = t
    return rwkv6_wkv_bwd_ref(r, k, v, logw, u, do, *(
        (s0, ds) if with_state else (None, None)))


@pytest.mark.parametrize("with_state", [False, True], ids=["zeros", "s0"])
@pytest.mark.parametrize("s", [37, 64])
def test_plain_reverse_matches_jax_vjp_of_scan(s, with_state):
    r, k, v, logw, u, do, s0, ds = _inputs(2, s, 2, 16, seed=s + with_state)
    if not with_state:
        s0, ds = np.zeros_like(s0), np.zeros_like(ds)
    want = _jax_vjp(_scan, r, k, v, logw, u, do, s0, ds)
    got = _torch_grads(r, k, v, logw, u, do, s0, ds, with_state)
    for name, g, w in zip(NAMES, got, want):
        if not with_state and name == "ds0":
            assert g is None
            continue
        assert g.dtype == torch.float32
        _assert_close(g.numpy(), w, name)


@pytest.mark.parametrize("with_state", [False, True], ids=["zeros", "s0"])
def test_plain_reverse_matches_jax_vjp_of_chunked(with_state):
    """s 128, two 64-token chunks of the reference's chunk-parallel form,
    at the usual decays."""
    r, k, v, logw, u, do, s0, ds = _inputs(1, 128, 2, 16, seed=5 + with_state)
    if not with_state:
        s0, ds = np.zeros_like(s0), np.zeros_like(ds)
    want = _jax_vjp(lambda *a: jrw.wkv_chunked(*a, chunk=64), r, k, v, logw,
                    u, do, s0, ds)
    got = _torch_grads(r, k, v, logw, u, do, s0, ds, with_state)
    for name, g, w in list(zip(NAMES, got, want))[:6 if with_state else 5]:
        _assert_close(g.numpy(), w, name)


@pytest.mark.parametrize("s", [45, 128])
def test_plain_reverse_full_decay_range_matches_fp64(s):
    """The model's full decay range: w from 1 - 2e-9 to 0 (the module
    note says why the fp64 reverse is the yardstick here)."""
    args = _inputs(2, s, 2, 16, seed=200 + s, decay=(-20.0, 10.0))
    got = _torch_grads(*args, True)
    want = _torch_grads(*args, True, dtype=torch.float64)
    for name, g, w in zip(NAMES, got, want):
        assert g.dtype == torch.float32 and w.dtype == torch.float64
        _assert_close(g.numpy(), w.numpy(), name)
    # and the per-token scan's vjp agrees there too
    for name, g, w in zip(NAMES, got, _jax_vjp(_scan, *args)):
        _assert_close(g.numpy(), w, name)


@pytest.mark.parametrize("with_s0", [False, True], ids=["zeros", "s0"])
def test_function_passes_gradcheck_in_float64(with_s0):
    rng = np.random.default_rng(11)
    b, s, h, n = 2, 7, 2, 3
    r, k, v = (torch.from_numpy(rng.standard_normal((b, s, h, n)))
               .requires_grad_() for _ in range(3))
    logw = torch.from_numpy(-rng.uniform(0.05, 2.0, (b, s, h, n))) \
        .requires_grad_()
    u = torch.from_numpy(rng.standard_normal((h, n))).requires_grad_()
    s0 = (torch.from_numpy(rng.standard_normal((b, h, n, n))).requires_grad_()
          if with_s0 else None)
    assert torch.autograd.gradcheck(
        lambda *a: WkvFn.apply(*a, False), (r, k, v, logw, u, s0))


def _block_params():
    jcfg, tcfg = jsmoke("rwkv6-3b"), tsmoke("rwkv6-3b")
    jp = jinit.init_params(jcfg, jax.random.key(0))["blocks"]
    tm = dict(jax.tree.map(lambda a: a[0], jp)["tm"])
    # decay_b and the bonus start at fixed values: give every term work
    rng = np.random.default_rng(0)
    for name in ("decay_b", "bonus", "decay_base"):
        tm[name] = jnp.asarray(tm[name] + 0.1 * rng.standard_normal(
            tm[name].shape), jnp.float32)
    return jcfg, tcfg, tm, params_from_numpy(jax.tree.map(np.asarray, tm),
                                             "cpu")


@pytest.mark.parametrize("s", [40, 128])
def test_time_mix_gradients_match_jax_grad(s):
    """x and every time-mix parameter, the WKV's gradient coming through
    WkvFn on the plain versions, against ``jax.grad`` of the reference's
    ``time_mix`` (its per-token scan at 40 tokens, chunked at 128)."""
    jcfg, tcfg, jp, tp = _block_params()
    rng = np.random.default_rng(s)
    x = rng.standard_normal((2, s, jcfg.d_model)).astype(np.float32)
    dy = rng.standard_normal((2, s, jcfg.d_model)).astype(np.float32)

    def jloss(x, p):
        y, _ = jrw.time_mix(x, p, jcfg)
        return jnp.sum(y * jnp.asarray(dy))

    jdx, jdp = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x), jp)
    tx = torch.from_numpy(x).requires_grad_()
    leaves = {k: v.detach().clone().requires_grad_() for k, v in tp.items()}
    y, _ = trw.time_mix(tx, leaves, tcfg)
    names = sorted(leaves)
    got = torch.autograd.grad(y, [tx] + [leaves[k] for k in names],
                              torch.from_numpy(dy))
    _assert_close(got[0].numpy(), jdx, "x")
    for name, g in zip(names, got[1:]):
        assert float(g.abs().max()) > 0, name
        _assert_close(g.numpy(), jdp[name], name)


def test_recorded_and_serving_calls():
    """With grad the call goes through the Function and gives the plain
    forward's outputs bit for bit; without grad it does not."""
    r, k, v, logw, u, _, s0, _ = (torch.from_numpy(a)
                                  for a in _inputs(1, 20, 2, 8, seed=4))
    plain = rwkv6_wkv(r, k, v, logw, u, s0)
    r.requires_grad_()
    recorded = rwkv6_wkv(r, k, v, logw, u, s0)
    for out in recorded:
        assert "WkvFn" in type(out.grad_fn).__name__
    assert all(torch.equal(a.detach(), b) for a, b in zip(recorded, plain))
    with torch.no_grad():
        assert rwkv6_wkv(r, k, v, logw, u, s0)[0].grad_fn is None


def test_reverse_kernel_refuses_cpu_tensors_and_other_dtypes():
    r, k, v, logw, u, do, s0, ds = (torch.from_numpy(a)
                                    for a in _inputs(1, 7, 2, 16, seed=2))
    states = torch.zeros((1, 2, 1, 16, 16))
    n = kmod.LAUNCHES_BWD
    with pytest.raises(ValueError, match="CUDA"):
        kmod.rwkv6_wkv_bwd(r, k, v, logw, u, do, states, s0, ds)
    r.requires_grad_()
    with pytest.raises(ValueError, match="CUDA"):
        rwkv6_wkv(r, k, v, logw, u, impl="kernel")
    assert kmod.LAUNCHES_BWD == n


def test_plain_reverse_of_bf16_inputs_carries_fp32():
    """bf16 inputs: the carry is fp32 and each gradient is rounded once
    (du in u's dtype)."""
    r, k, v, logw, u, do, s0, ds = (torch.from_numpy(a)
                                    for a in _inputs(1, 30, 2, 16, seed=9))
    rb, kb, vb, wb, dob = (t.bfloat16() for t in (r, k, v, logw, do))
    got = rwkv6_wkv_bwd_ref(rb, kb, vb, wb, u, dob, s0, ds)
    want = rwkv6_wkv_bwd_ref(rb.float(), kb.float(), vb.float(), wb.float(),
                             u, dob.float(), s0, ds)
    for name, g, w in zip(NAMES, got, want):
        assert g.dtype == (torch.bfloat16 if name in NAMES[:4]
                           else torch.float32), name
        want_g = w.to(torch.bfloat16) if name in NAMES[:4] else w
        assert torch.equal(g, want_g), name
    assert rwkv6_wkv_ref(rb, kb, vb, wb, u)[1].dtype == torch.float32
