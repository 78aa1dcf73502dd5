"""The gradient of the port's RG-LRU scan against the reference's, on the
same numpy inputs in fp32:

* the plain reverse scan ``rglru_scan_bwd_ref`` against ``jax.vjp`` of the
  reference's oracle ``repro.kernels.rglru_scan.ref.rglru_scan_ref`` (an
  associative scan), from zeros and from an initial state (folded into
  the first step, as the model's scan folds it), at seq 37 and 300 and
  channels 40 and 64;
* ``RglruScanFn`` through ``torch.autograd.gradcheck`` in float64 (the
  plain versions carry in fp64 there), with and without an h0;
* the port's model scan ``models.rglru.rglru_scan`` from an h0, its
  gradients for x, every gate parameter and h0 against ``jax.vjp`` of
  ``repro.models.rglru.rglru_scan`` (one associative scan at 37 and 300
  tokens, the 256-token chunked scan at 512);
* ``recurrent_block``'s gradients, for x and every parameter, against
  ``jax.grad`` of ``repro.models.rglru.recurrent_block``;
* what the kernel path refuses on the CPU, and that serving (no grad)
  does not go through the Function.

Tolerance: atol/rtol 1e-5.  The serial recurrence and the reference's
associative scan multiply the decays in another order (a product of up
to 300 factors in (0.85, 1) rounds apart by a few fp32 ulps), which
keeps them about 1e-6 relative apart; the block adds fp32 matmuls in
another summation order.  A weight's gradient sums over all b x s
tokens, terms of either sign up to ~100, so an element that cancels to
a small value carries the sums' fp32 rounding as a large relative error:
each weight-gradient leaf is held to 1e-5 of its largest element
(``_assert_leaf_close``) and 1e-5 relative.  The CUDA kernel is held
against the plain reverse scan bit for bit on the card
(``test_torch_rglru_bwd_cuda.py``, ``chip_smoke.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke as jsmoke  # noqa: E402
from repro.kernels.rglru_scan.ref import rglru_scan_ref as jax_ref  # noqa: E402
from repro.models import init as jinit  # noqa: E402
from repro.models import rglru as jrg  # noqa: E402
from repro_torch.configs import get_smoke as tsmoke  # noqa: E402
from repro_torch.kernels.rglru_scan import rglru_scan as kmod  # noqa: E402
from repro_torch.kernels.rglru_scan.ops import (RglruScanFn,  # noqa: E402
                                                rglru_scan)
from repro_torch.kernels.rglru_scan.ref import (  # noqa: E402
    rglru_scan_bwd_ref, rglru_scan_ref)
from repro_torch.models import rglru as trg  # noqa: E402
from repro_torch.models.init import params_from_numpy  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)


def _inputs(b, s, c, seed):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.85, 0.999, (b, s, c)).astype(np.float32)
    x = (0.1 * rng.standard_normal((b, s, c))).astype(np.float32)
    dh = rng.standard_normal((b, s, c)).astype(np.float32)
    h0 = rng.standard_normal((b, c)).astype(np.float32)
    return a, x, dh, h0


def _jax_scan_h0(a, b, h0):
    """The reference oracle from an initial state: h0 folded into the
    first step's input, as the model's chunked scan folds its carry."""
    return jax_ref(a, b.at[:, 0].add(a[:, 0] * h0))


@pytest.mark.parametrize("with_h0", [False, True], ids=["zeros", "h0"])
@pytest.mark.parametrize("s,c", [(37, 40), (37, 64), (300, 40), (300, 64)])
def test_plain_reverse_scan_matches_jax_vjp(s, c, with_h0):
    a, x, dh, h0 = _inputs(2, s, c, seed=s + c + with_h0)
    ja, jx, jdh, jh0 = map(jnp.asarray, (a, x, dh, h0))
    if with_h0:
        h_j, vjp = jax.vjp(_jax_scan_h0, ja, jx, jh0)
        want = vjp(jdh)
    else:
        h_j, vjp = jax.vjp(jax_ref, ja, jx)
        want = (*vjp(jdh), None)
    ta, tx, tdh = map(torch.from_numpy, (a, x, dh))
    th0 = torch.from_numpy(h0) if with_h0 else None
    h = rglru_scan_ref(ta, tx, th0)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_j), **TOL)
    got = rglru_scan_bwd_ref(ta, h, tdh, th0)
    for name, g, w in zip(("da", "db", "dh0"), got, want):
        if w is None:
            assert g is None
            continue
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name,
                                   **TOL)


@pytest.mark.parametrize("with_h0", [False, True], ids=["zeros", "h0"])
def test_function_passes_gradcheck_in_float64(with_h0):
    rng = np.random.default_rng(7)
    a = torch.from_numpy(rng.uniform(0.5, 0.99, (2, 9, 3))).requires_grad_()
    x = torch.from_numpy(rng.standard_normal((2, 9, 3))).requires_grad_()
    h0 = (torch.from_numpy(rng.standard_normal((2, 3))).requires_grad_()
          if with_h0 else None)
    assert torch.autograd.gradcheck(
        lambda a, x, h0: RglruScanFn.apply(a, x, h0, False), (a, x, h0))


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


def _assert_leaf_close(got, want, name):
    """A weight's gradient: each element within 1e-5 of the leaf's
    largest plus 1e-5 relative (the module note)."""
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, err_msg=name, rtol=TOL["rtol"],
                               atol=TOL["atol"] * float(np.abs(want).max()))


def _leaf_grads(tp):
    return {k: v.detach().clone().requires_grad_() for k, v in tp.items()}


@pytest.mark.parametrize("s", [37, 300, 512])
def test_model_scan_gradients_with_state_match_jax(s):
    """x, the gate parameters and h0 through the port's ``rglru_scan``
    (RglruScanFn on the plain versions) against ``jax.vjp`` of the
    reference's, with cotangents on both outputs (y and the final
    state)."""
    jcfg, _, jp, tp = _rec_params()
    rng = np.random.default_rng(s)
    w = jcfg.lru_width
    x = rng.standard_normal((2, s, w)).astype(np.float32)
    h0 = rng.standard_normal((2, w)).astype(np.float32)
    dy = rng.standard_normal((2, s, w)).astype(np.float32)
    dhl = rng.standard_normal((2, w)).astype(np.float32)
    gate_keys = ("lru_wa", "lru_ba", "lru_wx", "lru_bx", "lru_a")

    def jf(x, gates, h0):
        return jrg.rglru_scan(x, {**jp, **gates}, h0)

    _, vjp = jax.vjp(jf, jnp.asarray(x), {k: jp[k] for k in gate_keys},
                     jnp.asarray(h0))
    jdx, jdg, jdh0 = vjp((jnp.asarray(dy), jnp.asarray(dhl)))
    tx, th0 = (torch.from_numpy(t).requires_grad_() for t in (x, h0))
    gates = _leaf_grads({k: tp[k] for k in gate_keys})
    y, hl = trg.rglru_scan(tx, {**tp, **gates}, th0)
    got = torch.autograd.grad((y, hl), (tx, th0, *gates.values()),
                              (torch.from_numpy(dy), torch.from_numpy(dhl)))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(jdx), **TOL)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(jdh0), **TOL)
    for name, g in zip(gate_keys, got[2:]):
        _assert_leaf_close(g.numpy(), jdg[name], name)


def test_recurrent_block_gradients_match_jax_grad():
    jcfg, tcfg, jp, tp = _rec_params(seed=1)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 40, jcfg.d_model)).astype(np.float32)
    dy = rng.standard_normal((2, 40, jcfg.d_model)).astype(np.float32)

    def jloss(x, p):
        y, _ = jrg.recurrent_block(x, p, jcfg)
        return jnp.sum(y * jnp.asarray(dy))

    jdx, jdp = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x), jp)
    tx = torch.from_numpy(x).requires_grad_()
    leaves = _leaf_grads(tp)
    y, _ = trg.recurrent_block(tx, leaves, tcfg)
    names = sorted(leaves)
    got = torch.autograd.grad(y, [tx] + [leaves[k] for k in names],
                              torch.from_numpy(dy))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(jdx), **TOL)
    for name, g in zip(names, got[1:]):
        assert float(g.abs().max()) > 0, name
        _assert_leaf_close(g.numpy(), jdp[name], name)


def test_reverse_scan_bf16_rounds_each_output_once():
    """bf16 inputs: the carry stays fp32, da and db are rounded once."""
    a, x, dh, h0 = (torch.from_numpy(t) for t in _inputs(2, 40, 16, seed=3))
    ab, hb, dhb = (t.to(torch.bfloat16) for t in
                   (a, rglru_scan_ref(a, x), dh))
    da, db, dh0 = rglru_scan_bwd_ref(ab, hb, dhb, h0)
    wa, wb, w0 = rglru_scan_bwd_ref(ab.float(), hb.float(), dhb.float(), h0)
    assert da.dtype == db.dtype == torch.bfloat16
    assert dh0.dtype == torch.float32
    assert torch.equal(da, wa.to(torch.bfloat16))
    assert torch.equal(db, wb.to(torch.bfloat16))
    assert torch.equal(dh0, w0)


def test_recorded_and_serving_calls():
    """With grad the call goes through the Function and gives the plain
    forward's output bit for bit; without grad it does not."""
    a, x, _, h0 = (torch.from_numpy(t) for t in _inputs(1, 20, 8, seed=4))
    plain = rglru_scan(a, x, h0)
    x.requires_grad_()
    recorded = rglru_scan(a, x, h0)
    assert "RglruScanFn" in type(recorded.grad_fn).__name__
    assert torch.equal(recorded.detach(), plain)
    with torch.no_grad():
        assert rglru_scan(a, x, h0).grad_fn is None


def test_reverse_kernel_refuses_cpu_tensors():
    a, x, dh, h0 = (torch.from_numpy(t) for t in _inputs(1, 7, 5, seed=2))
    h = rglru_scan_ref(a, x)
    n = kmod.LAUNCHES_BWD
    with pytest.raises(ValueError, match="CUDA"):
        kmod.rglru_scan_bwd(a, h, dh, h0)
    x.requires_grad_()
    with pytest.raises(ValueError, match="CUDA"):
        rglru_scan(a, x, impl="kernel")
    assert kmod.LAUNCHES_BWD == n
