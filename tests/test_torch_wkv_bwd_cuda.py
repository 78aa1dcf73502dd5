"""Card-only: the RWKV-6 WKV reverse (``rwkv6_wkv_bwd``, the WKV's
gradient) against its plain version ``rwkv6_wkv_bwd_ref`` on the card:
SMOKE widths (n 16), n 32 and rwkv6-3b's n 64 (two row blocks a head, a
cluster summing dv between them), lengths that are no multiple of the
32-token chunk, from zeros and from a nonzero s0 with a nonzero final
state gradient, the usual and the model's full decay range, batch rows
2 and 3 (du summed over them and over the segments), sequences split
into segments with a ragged last one ((1, 4096 + 37, 8, 64): 44
segments of 3 chunks, the last one 5-token chunk; (2, 1000, 4, 32): 32
of one chunk, the last of 8 tokens), views no row of which is 16-byte
aligned; the
autograd Function on CUDA tensors against the same Function on the plain
versions; a CUDA-graph replay; and the serving forward, whose
chunk-state output stays null, unchanged in bits and launches.

Tolerance: each gradient within 1e-4 of its largest element plus 1e-4
relative (``WKV_BWD_RTOL``).  The plain fp32 reverse lies within ~2e-7
of the largest element from an fp64 one for the per-token gradients and
within ~2.2e-6 for du, which sums 4,096 tokens (rwkv6-3b's training
shape, both decay ranges, measured on the host); the kernel sums its
column blocks, warps and lanes in another order, so it may lie up to
twice that from the plain version.  A wrong index or a missing term
moves an element by the order of the largest.  Two calls must be
bit-identical (no atomics).  The kernels have no CPU mode, so every test
carries the ``cuda`` marker and skips without a card:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_wkv_bwd_cuda.py
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.rwkv6_wkv import rwkv6_wkv as wmod  # noqa: E402
from repro_torch.kernels.rwkv6_wkv.ops import rwkv6_wkv  # noqa: E402
from repro_torch.kernels.rwkv6_wkv.ref import (  # noqa: E402
    rwkv6_wkv_bwd_ref, rwkv6_wkv_ref)

pytestmark = pytest.mark.cuda

WKV_BWD_RTOL = 1e-4
DECAYS = {"usual": (-6.0, -1.0), "full": (-20.0, 10.0)}
NAMES = ("dr", "dk", "dv", "dlogw", "du", "ds0")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels have no CPU mode")
    return torch.device("cuda")


def _inputs(dev, b, s, h, n, with_state, decay, pad=0, seed=0):
    """fp32 r, k, v, logw in the model's layout ((b, s, h*n) viewed as
    (b, s, h, n); ``pad`` > 0 cuts them from rows ``pad`` elements wider
    at offset ``pad``, so no row is 16-byte aligned), u, the output's
    gradient, and s0 / the final state's gradient (or None)."""
    g = torch.Generator(device=dev).manual_seed(seed + s + h + n)

    def proj(x):
        return x[..., pad:].unflatten(-1, (h, n))

    r, k, v = (proj(0.5 * torch.randn((b, s, h * n + pad), generator=g,
                                      device=dev)) for _ in range(3))
    logw = proj(-torch.exp(torch.empty((b, s, h * n + pad), device=dev)
                           .uniform_(*DECAYS[decay], generator=g)))
    u = 0.1 * torch.randn((h, n), generator=g, device=dev)
    do = torch.randn((b, s, h, n), generator=g, device=dev)
    s0, ds = ((torch.randn((b, h, n, n), generator=g, device=dev)
               for _ in range(2)) if with_state else (None, None))
    return r, k, v, logw, u, do, s0, ds


def _assert_close(got, want, name):
    err = (got - want).abs()
    lim = WKV_BWD_RTOL * (want.abs().max() + want.abs())
    assert bool((err <= lim).all()), (name, err.max().item(),
                                      want.abs().max().item())


def _check(r, k, v, logw, u, do, s0, ds):
    """The reverse kernel against the plain one, two calls bit-identical,
    one count a call; the forward's chunk states start from s0."""
    _, _, states = wmod.rwkv6_wkv(r, k, v, logw, u, s0, states=True)
    first = states[:, :, 0]
    assert torch.equal(first, s0 if s0 is not None
                       else torch.zeros_like(first))
    n0 = wmod.LAUNCHES_BWD
    out = wmod.rwkv6_wkv_bwd(r, k, v, logw, u, do, states, s0, ds)
    again = wmod.rwkv6_wkv_bwd(r, k, v, logw, u, do, states, s0, ds)
    torch.cuda.synchronize()
    assert wmod.LAUNCHES_BWD == n0 + 2
    ref = rwkv6_wkv_bwd_ref(r, k, v, logw, u, do, s0, ds)
    for name, o, o2, w in zip(NAMES, out, again, ref):
        if w is None:
            assert o is None and o2 is None, name
            continue
        assert o.dtype == w.dtype == torch.float32 and o.shape == w.shape
        assert torch.equal(o, o2), name
        _assert_close(o, w, name)


@pytest.mark.parametrize("decay", sorted(DECAYS))
@pytest.mark.parametrize("b,s,h,n,with_state", [
    (2, 37, 4, 16, True), (2, 64, 4, 16, False), (1, 1, 2, 32, True),
    (3, 77, 4, 32, True), (1, 300, 40, 64, False), (1, 129, 8, 64, True),
    (2, 33, 40, 64, True), (1, 4096 + 37, 8, 64, True),
    (2, 1000, 4, 32, True), (2, 300, 8, 64, True)])
def test_rwkv6_wkv_bwd_kernel_matches_plain(card, b, s, h, n, with_state,
                                            decay):
    _check(*_inputs(card, b, s, h, n, with_state, decay))


@pytest.mark.parametrize("b,s,h,n", [(1, 70, 8, 64), (2, 37, 4, 16)])
def test_rwkv6_wkv_bwd_kernel_unaligned_views(card, b, s, h, n):
    """Views whose rows are not 16-byte aligned take the element-by-
    element staging."""
    args = _inputs(card, b, s, h, n, True, "full", pad=1)
    assert args[0].data_ptr() % 16 and not args[0].is_contiguous()
    _check(*args)


def test_rwkv6_wkv_bwd_refuses_bf16_and_cpu(card):
    r, k, v, logw, u, do, s0, ds = _inputs(card, 1, 20, 2, 16, True, "usual")
    _, _, states = wmod.rwkv6_wkv(r, k, v, logw, u, s0, states=True)
    n0 = wmod.LAUNCHES_BWD
    bf = [t.bfloat16() for t in (r, k, v, logw)]
    with pytest.raises(ValueError, match="dtypes"):
        wmod.rwkv6_wkv_bwd(*bf, u, do, states, s0, ds)
    with pytest.raises(ValueError, match="CUDA"):
        wmod.rwkv6_wkv_bwd(*(t.cpu() for t in (r, k, v, logw, u, do,
                                               states)))
    assert wmod.LAUNCHES_BWD == n0


def test_autograd_on_card_matches_plain(card):
    """``ops.rwkv6_wkv`` under autograd on CUDA tensors (forward and
    reverse kernels) against the same Function on the plain versions,
    with gradients on both outputs: one launch each way."""
    r, k, v, logw, u, do, s0, ds = _inputs(card, 2, 100, 4, 64, True,
                                           "usual")
    grads = {}
    for impl in ("kernel", "ref"):
        leaves = [t.detach().clone().requires_grad_()
                  for t in (r, k, v, logw, u, s0)]
        n0, b0 = wmod.LAUNCHES, wmod.LAUNCHES_BWD
        o, s1 = rwkv6_wkv(*leaves, impl=impl)
        assert "WkvFn" in type(o.grad_fn).__name__
        grads[impl] = torch.autograd.grad((o, s1), leaves, (do, ds))
        assert (wmod.LAUNCHES - n0, wmod.LAUNCHES_BWD - b0) == (
            (1, 1) if impl == "kernel" else (0, 0))
    for name, a, w in zip(("dr", "dk", "dv", "dlogw", "du", "ds0"),
                          grads["kernel"], grads["ref"]):
        _assert_close(a, w, name)


def test_rwkv6_wkv_bwd_graph_replay_is_bit_identical(card):
    """A CUDA-graph replay of the reverse gives the eager call's
    outputs."""
    r, k, v, logw, u, do, s0, ds = _inputs(card, 1, 300, 40, 64, True,
                                           "usual")
    _, _, states = wmod.rwkv6_wkv(r, k, v, logw, u, s0, states=True)

    def call():
        return wmod.rwkv6_wkv_bwd(r, k, v, logw, u, do, states, s0, ds)

    eager = call()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        out = call()
    for t in out:
        t.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(o, e) for o, e in zip(out, eager))


@pytest.mark.parametrize("with_state", [False, True], ids=["zeros", "s0"])
def test_serving_forward_keeps_its_bits_and_launches(card, with_state):
    """Without autograd the forward runs with its chunk-state output
    null: one launch, and the output and final state are those of the
    forward that keeps the states (which the plain version matches)."""
    r, k, v, logw, u, _, s0, _ = _inputs(card, 1, 300, 40, 64, with_state,
                                         "usual")
    n0, b0 = wmod.LAUNCHES, wmod.LAUNCHES_BWD
    with torch.no_grad():
        o, s1 = rwkv6_wkv(r, k, v, logw, u, s0, impl="kernel")
    assert (wmod.LAUNCHES - n0, wmod.LAUNCHES_BWD - b0) == (1, 0)
    o2, s2, _ = wmod.rwkv6_wkv(r, k, v, logw, u, s0, states=True)
    assert torch.equal(o, o2) and torch.equal(s1, s2)
    o_ref, s_ref = rwkv6_wkv_ref(r, k, v, logw, u, s0)
    torch.testing.assert_close(o, o_ref, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(s1, s_ref, atol=1e-4, rtol=1e-4)
