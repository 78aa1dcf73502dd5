"""The gradient of the port's flash attention against ``jax.grad`` of the
reference's XLA attention (``repro.models.attention.attention``, whose
autodiff is the reference's attention gradient), on the same numpy
inputs in fp32:

* the plain backward ``attention_bwd_ref`` fed ``attention_ref``'s output
  and row log-sum-exp;
* the ``torch.autograd.Function`` behind ``flash_attention_bshd`` (on CPU
  tensors: ``attention_ref`` with LSE, then ``attention_bwd_ref``; the
  same saved tensors, layouts and GQA reduction the card's kernels get);
* torch autograd of the plain forward ``attention_ref``.

Cases: GQA (g 1, 2, 3, 4, 10), causal, windowed and full masks, ragged
lengths, head_dim 16 to 256 (recurrentgemma-2b's: MQA with a group of
10 under a window), and non-causal with fewer and with more keys than
queries (whisper's cross-attention).  Tolerance 1e-5 (atol and rtol): the same fp32
arithmetic in another summation order.  Then what the Function and the
backward kernel's wrapper refuse (``ValueError`` before any launch), and
exact zeros for rows that see no key.  The CUDA kernel itself is held
against ``attention_bwd_ref`` on the card (``test_torch_kernels_cuda.py``,
``chip_smoke.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models.attention import attention as jax_attention  # noqa: E402
from repro_torch.kernels.flash_attention import \
    flash_attention as fmod  # noqa: E402
from repro_torch.kernels.flash_attention.ops import (  # noqa: E402
    FlashAttentionFn, flash_attention_bshd)
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    attention_bwd_ref, attention_ref)

TOL = dict(atol=1e-5, rtol=1e-5)

# (b, hq, hkv, sq, d, causal, window[, skv]): skv defaults to sq
CASES = [
    (1, 3, 1, 37, 16, True, 0),        # g 3, one ragged tile
    (2, 6, 3, 45, 32, True, 0),        # g 2
    (1, 9, 3, 70, 64, True, 0),        # smollm-135m's heads
    (2, 4, 2, 50, 16, True, 12),       # sliding window
    (1, 4, 4, 33, 16, False, 0),       # MHA, no mask
    (1, 4, 2, 40, 128, True, 8),       # head_dim 128, window
    (1, 10, 1, 70, 256, True, 24),     # recurrentgemma-2b's heads, window
    # non-causal, sq != skv (whisper's cross-attention: 448 queries x
    # 1500 keys, both ragged against the kernels' 64 / 128 tiles; and
    # fewer keys than queries), group 1 and 4
    (2, 4, 4, 12, 64, False, 0, 40),
    (1, 8, 2, 12, 16, False, 0, 40),
    (2, 4, 4, 40, 16, False, 0, 24),
    (1, 8, 2, 40, 128, False, 0, 24),
]
IDS = [f"b{c[0]}-hq{c[1]}-hkv{c[2]}-s{c[3]}-d{c[4]}-"
       f"{'causal' if c[5] else 'full'}-w{c[6]}"
       + (f"-kv{c[7]}" if len(c) > 7 else "") for c in CASES]


def _inputs(b, hq, hkv, sq, d, seed, skv=None):
    """(b, s, h, d) q, k, v and the output's gradient, as numpy; k and v
    hold ``skv`` positions (default sq)."""
    skv = sq if skv is None else skv
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, hq, d)).astype(np.float32)
    k = rng.standard_normal((b, skv, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, skv, hkv, d)).astype(np.float32)
    do = rng.standard_normal((b, sq, hq, d)).astype(np.float32)
    return q, k, v, do


def _jax_grads(q, k, v, do, causal, window):
    def f(q, k, v):
        o = jax_attention(q, k, v, causal=causal, window=window)
        return jnp.sum(o * do)

    return [np.asarray(g) for g in
            jax.grad(f, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))]


@pytest.fixture(scope="module", params=CASES, ids=IDS)
def case(request):
    b, hq, hkv, sq, d, causal, window, *rest = request.param
    skv = rest[0] if rest else sq
    q, k, v, do = _inputs(b, hq, hkv, sq, d, seed=skv + d + window,
                          skv=skv)
    return dict(arrays=(q, k, v, do), causal=causal, window=window,
                jax=_jax_grads(q, k, v, do, causal, window))


def _close(got, want):
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(np.asarray(g), w, err_msg=f"d{name}",
                                   **TOL)


def test_plain_backward_matches_jax_grad(case):
    q, k, v, do = (torch.from_numpy(a).transpose(1, 2)
                   for a in case["arrays"])
    kw = dict(causal=case["causal"], window=case["window"])
    o, lse = attention_ref(q, k, v, return_lse=True, **kw)
    grads = attention_bwd_ref(q, k, v, o, lse, do, **kw)
    _close([g.transpose(1, 2).numpy() for g in grads], case["jax"])


def _autograd(fn, case):
    q, k, v, do = (torch.from_numpy(a) for a in case["arrays"])
    for t in (q, k, v):
        t.requires_grad_()
    o = fn(q, k, v)
    return [g.numpy() for g in torch.autograd.grad(o, (q, k, v), do)]


def test_autograd_function_matches_jax_grad(case):
    kw = dict(causal=case["causal"], window=case["window"])
    _close(_autograd(lambda q, k, v: flash_attention_bshd(q, k, v, **kw),
                     case), case["jax"])


def test_autograd_function_matches_torch_autograd_of_plain(case):
    kw = dict(causal=case["causal"], window=case["window"])
    plain = _autograd(lambda q, k, v: attention_ref(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        **kw).transpose(1, 2), case)
    _close(_autograd(lambda q, k, v: flash_attention_bshd(q, k, v, **kw),
                     case), plain)


def test_lse_is_the_masked_logsumexp(case):
    q, k, v, _ = (torch.from_numpy(a).transpose(1, 2)
                  for a in case["arrays"])
    causal, window = case["causal"], case["window"]
    _, lse = attention_ref(q, k, v, causal=causal, window=window,
                           return_lse=True)
    b, hq, sq, d = q.shape
    g = hq // k.shape[1]
    s = torch.einsum("bhqd,bhkd->bhqk", q.double() * d ** -0.5,
                     k.double().repeat_interleave(g, dim=1))
    pos = torch.arange(sq)                  # causal cases have skv == sq
    mask = torch.ones((sq, k.shape[2]), dtype=torch.bool)
    if causal:
        mask &= pos[None, :] <= pos[:, None]
    if window:
        mask &= pos[None, :] > pos[:, None] - window
    want = torch.logsumexp(s.masked_fill(~mask, -torch.inf), dim=-1)
    np.testing.assert_allclose(lse.numpy(), want.numpy(), **TOL)


def test_forward_output_unchanged_by_autograd():
    """The recorded path (the Function, with LSE) gives the plain
    forward's output bit for bit, and without grad the call does not go
    through the Function at all."""
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(2, 6, 3, 45, 32, 1))
    plain = flash_attention_bshd(q, k, v, window=9)
    q.requires_grad_()
    recorded = flash_attention_bshd(q, k, v, window=9)
    fn = recorded.grad_fn.next_functions[0][0]     # under the transpose
    assert "FlashAttentionFn" in type(fn).__name__
    assert torch.equal(recorded.detach(), plain)
    with torch.no_grad():
        assert flash_attention_bshd(q, k, v, window=9).grad_fn is None


@pytest.mark.parametrize("what", ["group", "dtypes", "float16", "kv_shape"])
def test_function_refuses_what_the_kernel_refuses(what):
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(1, 4, 2, 16, 16, 2))
    if what == "group":
        k, v = (torch.from_numpy(a)
                for a in _inputs(1, 4, 3, 16, 16, 2)[1:3])
    elif what == "dtypes":
        k = k.to(torch.bfloat16)
    elif what == "float16":
        q, k, v = (t.half() for t in (q, k, v))
    else:
        v = v[:, :8]
    q.requires_grad_()
    with pytest.raises(ValueError, match="flash_attention"):
        flash_attention_bshd(q, k, v)


@pytest.mark.parametrize("d", [16, 32, 96])
def test_backward_kernel_refuses_other_head_dims(d):
    """The backward kernel takes head_dim 64, 128 and 256: every other
    one is refused with a ValueError before anything reaches the card —
    by the wrapper, by the Function's forward on the kernel path, and by
    the shared check."""
    q, k, v, do = (torch.from_numpy(a).transpose(1, 2)
                   for a in _inputs(1, 4, 2, 16, d, 3))
    o, lse = attention_ref(q, k, v, return_lse=True)
    with pytest.raises(ValueError, match="head_dim"):
        fmod.check_inputs(q, k, v, fmod.BWD_HEAD_DIMS)
    with pytest.raises(ValueError, match="head_dim"):
        fmod.flash_attention_bwd(q, k, v, o, lse, do)
    with pytest.raises(ValueError, match="head_dim"):
        FlashAttentionFn.apply(q.requires_grad_(), k, v, True, 0, True)
    assert fmod.BWD_HEAD_DIMS == (64, 128, 256)


def test_backward_kernel_wrapper_needs_cuda_tensors():
    q, k, v, do = (torch.from_numpy(a).transpose(1, 2)
                   for a in _inputs(1, 4, 2, 16, 64, 4))
    o, lse = attention_ref(q, k, v, return_lse=True)
    n = fmod.LAUNCHES_BWD
    with pytest.raises(ValueError, match="CUDA tensors"):
        fmod.flash_attention_bwd(q, k, v, o, lse, do)
    assert fmod.LAUNCHES_BWD == n


def test_rows_that_see_no_key_get_zero_gradients():
    """More queries than keys under a causal window: rows q >= skv +
    window - 1 see no key.  Their dq is exactly 0 and nothing is NaN."""
    rng = np.random.default_rng(5)
    q = torch.from_numpy(rng.standard_normal((1, 2, 20, 16),
                                             dtype=np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((1, 1, 8, 16),
                                                 dtype=np.float32))
            for _ in range(2))
    do = torch.from_numpy(rng.standard_normal((1, 2, 20, 16),
                                              dtype=np.float32))
    o, lse = attention_ref(q, k, v, window=4, return_lse=True)
    dq, dk, dv = attention_bwd_ref(q, k, v, o, lse, do, window=4)
    for t in (dq, dk, dv):
        assert bool(torch.isfinite(t).all())
    assert bool((dq[:, :, 11:] == 0).all())
    assert bool((dq[:, :, :11] != 0).any())
