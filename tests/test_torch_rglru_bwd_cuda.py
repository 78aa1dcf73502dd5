"""Card-only: the RG-LRU reverse scan (``rglru_scan_bwd``, the scan's
gradient) against its plain version ``rglru_scan_bwd_ref`` on the card:
recurrentgemma-2b's training shape (1, 4096, 2560), lengths that are no
multiple of the 32-step chunk, widths that are no multiple of the
32-channel group (ch 40, 70: rows not 16-byte aligned, staged element by
element), a nonzero initial state (dh0), views no row of which is 16-byte
aligned, fp32 and bf16; then the autograd Function on CUDA tensors
against the same Function on the plain versions, and a CUDA-graph replay.

fp32 is bit-exact and bf16 too: the kernel rounds the same two ops as
the plain version (multiply, then add, fp32 carry) and each output once.
Every call is compared with a second one (bit-identical) and counted
once in ``LAUNCHES_BWD``.  The kernels have no CPU mode, so every test
carries the ``cuda`` marker and skips without a card:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_rglru_bwd_cuda.py
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.rglru_scan import rglru_scan as smod  # noqa: E402
from repro_torch.kernels.rglru_scan.ops import rglru_scan  # noqa: E402
from repro_torch.kernels.rglru_scan.ref import (  # noqa: E402
    rglru_scan_bwd_ref, rglru_scan_ref)

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels have no CPU mode")
    return torch.device("cuda")


def _inputs(dev, dtype, batch, seq, ch, with_h0, seed):
    """a in the model's decay range, the forward's h from a plain scan,
    a random output gradient, and h0 (fp32) or None."""
    g = torch.Generator(device=dev).manual_seed(seed)
    a = (0.85 + 0.149 * torch.rand((batch, seq, ch), generator=g,
                                   device=dev)).to(dtype)
    x = (0.1 * torch.randn((batch, seq, ch), generator=g,
                           device=dev)).to(dtype)
    dh = torch.randn((batch, seq, ch), generator=g, device=dev).to(dtype)
    h0 = torch.randn((batch, ch), generator=g, device=dev) if with_h0 else None
    return a, rglru_scan_ref(a, x, h0), dh, h0


def _check(a, h, dh, h0):
    """Kernel against the plain version bit for bit, two calls equal, one
    count a call."""
    n0 = smod.LAUNCHES_BWD
    out = smod.rglru_scan_bwd(a, h, dh, h0)
    again = smod.rglru_scan_bwd(a, h, dh, h0)
    torch.cuda.synchronize()
    assert smod.LAUNCHES_BWD == n0 + 2
    ref = rglru_scan_bwd_ref(a, h, dh, h0)
    for name, o, o2, r in zip(("da", "db", "dh0"), out, again, ref):
        if r is None:
            assert o is None and o2 is None, name
            continue
        assert o.dtype == r.dtype and o.shape == r.shape, name
        assert torch.equal(o, r), name
        assert torch.equal(o, o2), name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("batch,seq,ch,with_h0", [
    (1, 4096, 2560, False),            # recurrentgemma-2b's training shape
    (1, 300, 2560, True), (1, 37, 40, True), (3, 37, 200, True),
    (2, 1, 64, False), (1, 33, 70, False), (2, 129, 2560, True)])
def test_rglru_scan_bwd_kernel_matches_plain(card, dtype, batch, seq, ch,
                                             with_h0):
    _check(*_inputs(card, dtype, batch, seq, ch, with_h0, seq + ch))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_rglru_scan_bwd_kernel_unaligned_views(card, dtype):
    """Contiguous views one element past an aligned start (so no row is
    16-byte aligned) take the element-by-element staging."""
    batch, seq, ch = 2, 70, 256
    n = batch * seq * ch
    g = torch.Generator(device=card).manual_seed(9)

    def view(x):
        return x.to(dtype)[1:n + 1].view(batch, seq, ch)

    a = view(0.85 + 0.149 * torch.rand(n + 1, generator=g, device=card))
    h, dh = (view(torch.randn(n + 1, generator=g, device=card))
             for _ in range(2))
    assert a.is_contiguous() and a.data_ptr() % 16
    _check(a, h, dh, torch.randn((batch, ch), generator=g, device=card))


def test_autograd_on_card_matches_plain(card):
    """``ops.rglru_scan`` under autograd on CUDA tensors (forward and
    reverse kernels) against the same Function on the plain versions:
    the gradients of a, b and h0 bit for bit."""
    a, _, dh, h0 = _inputs(card, torch.float32, 2, 300, 2560, True, 3)
    b = 0.1 * torch.randn_like(a)
    grads = {}
    for impl in ("kernel", "ref"):
        leaves = [t.detach().clone().requires_grad_() for t in (a, b, h0)]
        n0, b0 = smod.LAUNCHES, smod.LAUNCHES_BWD
        h = rglru_scan(*leaves, impl=impl)
        grads[impl] = torch.autograd.grad(h, leaves, dh)
        assert (smod.LAUNCHES - n0, smod.LAUNCHES_BWD - b0) == (
            (1, 1) if impl == "kernel" else (0, 0))
    for k, r in zip(grads["kernel"], grads["ref"]):
        assert torch.equal(k, r)


def test_rglru_scan_bwd_graph_replay_is_bit_identical(card):
    """A CUDA-graph replay of the reverse scan gives the eager call's
    outputs."""
    a, h, dh, h0 = _inputs(card, torch.float32, 1, 300, 2560, True, 5)
    eager = smod.rglru_scan_bwd(a, h, dh, h0)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        smod.rglru_scan_bwd(a, h, dh, h0)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        out = smod.rglru_scan_bwd(a, h, dh, h0)
    for t in out:
        t.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(o, e) for o, e in zip(out, eager))
