"""Card-only: the grouped matmul's backward kernel
(``kernels/csrc/moe_gmm_bwd.cu``) and the MoE train step on CUDA.

* ``moe_gmm_bwd`` (dX and dW in one call) against ``moe_gmm_bwd_ref`` on
  the same inputs, fp32 on the CUDA cores and bf16 on the tensor cores
  (read from the counters): deepseek-moe-16b's training shapes (C = 960,
  the wi / wg and the wo products) with a top-6 routing's row counts, a
  ragged C with empty experts and values in the rows past the counts,
  shapes no tile divides, and no counts; and (``EDGES``) counts at the
  tensor-core instance's 16-row, 64-row stage and 128-row tile edges,
  counts all C and all 0, one expert, K and F narrower than one 64-wide
  TMA box or not a multiple of it; two calls bit-identical, dX zero past
  the counts.  Rows past the counts of x and dy hold finite random
  values, except in the routed cases (zeros there, as in the model's
  buffers).  Tolerances: fp32 atol/rtol 1e-5 against the plain version
  (the same fp32 sums in another order); at ``EDGES`` in fp32 both the
  kernel and the plain version within gamma_n sum_i |a_i b_i| of the
  fp64 sum at every element, gamma_n = n u / (1 - n u), u = 2^-24, n
  the reduction's length (F for dX, the expert's live rows for dW): the
  worst-case error of an fp32 sum of n products in any order (Higham,
  Accuracy and Stability of Numerical Algorithms, eq. 3.5), since an
  element near zero there is a sum that cancels, where 1e-5 + 1e-5
  |plain| is below what two summation orders may differ by; bf16 atol
  1.6e-2, rtol 1e-2 (both sides sum in fp32 and round once to bf16: one
  ulp apart at most);
* the tensor-core instance captured in a CUDA graph, its inputs and
  counts refilled in place: the replay equals a direct call bit for bit;
* ``MoeGmmFn`` with the kernels against autograd of the plain forward,
  the same tolerances;
* a bf16 deepseek-moe-16b SMOKE ``TrainStep`` (head_dim 64, the flash
  backward's) captured and called directly from the same state over 3
  batches: bit-identical params, m, v, step and metrics; launches per
  call exact and all on the tensor cores.

Every test carries the ``cuda`` marker and skips without a card.  On a
machine with one:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_moe_gmm_bwd_cuda.py
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.data.pipeline import DataPipeline  # noqa: E402
from repro_torch.kernels.flash_attention import \
    flash_attention as fa  # noqa: E402
from repro_torch.kernels.moe_gmm import moe_gmm as gmod  # noqa: E402
from repro_torch.kernels.moe_gmm.ops import moe_gmm  # noqa: E402
from repro_torch.kernels.moe_gmm.ref import (moe_gmm_bwd_ref,  # noqa: E402
                                             moe_gmm_ref)
from repro_torch.launch.strategy import (TrainStep,  # noqa: E402
                                         init_train_state)
from repro_torch.optim import AdamWConfig  # noqa: E402
from repro_torch.step_graph import WARMUP  # noqa: E402
from repro_torch.tree import flatten  # noqa: E402

pytestmark = pytest.mark.cuda

TOLS = {torch.float32: dict(atol=1e-5, rtol=1e-5),
        torch.bfloat16: dict(atol=1.6e-2, rtol=1e-2)}
SHAPES = [  # e, c, k, f, counts ("routed": a top-6 routing of 8,192 tokens)
    (64, 960, 2048, 1408, "routed"),
    (64, 960, 1408, 2048, "routed"),
    (8, 200, 256, 136, [0, 200, 37, 1, 0, 150, 199, 64]),
    (3, 5, 37, 19, [5, 0, 2]),
    (2, 130, 100, 70, None),
    (4, 48, 64, 48, None),
]
# the tensor-core instance's edges, run in bf16 and in fp32 (there on the
# CUDA-core instance)
EDGES = [
    # live rows at the 16-row step, 64-row stage and 128-row tile edges
    (9, 200, 64, 64, [15, 16, 17, 63, 64, 65, 127, 128, 129]),
    (2, 960, 256, 128, [960, 960]),
    (2, 960, 256, 128, [0, 0]),
    (1, 300, 128, 264, [250]),
    (2, 48, 8, 24, [48, 20]),           # narrower than one TMA box
    (3, 100, 136, 200, [17, 100, 65]),  # no box divides K or F
]


@pytest.fixture(autouse=True)
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = saved


def _inputs(card, dtype, e, c, k, f, counts, seed=None):
    g = torch.Generator(device=card).manual_seed(
        e + c + k + f if seed is None else seed)
    x = torch.randn((e, c, k), generator=g, device=card)
    w = torch.randn((e, k, f), generator=g, device=card) * k ** -0.5
    dy = torch.randn((e, c, f), generator=g, device=card)
    if counts == "routed":
        logits = torch.randn((8192, e), generator=g, device=card)
        idx = logits.topk(6, dim=-1).indices.reshape(-1)
        counts = torch.bincount(idx, minlength=e).clamp(max=c).int()
        x *= (torch.arange(c, device=card)[None, :] < counts[:, None])[
            ..., None]
    elif counts is not None:
        counts = torch.tensor(counts, dtype=torch.int32, device=card)
    return x.to(dtype), w.to(dtype), dy.to(dtype), counts


def _close(got, want, tol):
    torch.testing.assert_close(got.float(), want.float(), **tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("e,c,k,f,counts", SHAPES)
def test_moe_gmm_bwd_kernel_matches_plain(card, dtype, e, c, k, f, counts):
    _check_kernel(card, dtype, e, c, k, f, counts)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("e,c,k,f,counts", EDGES)
def test_kernel_edges_match_plain(card, dtype, e, c, k, f, counts):
    _check_kernel(card, dtype, e, c, k, f, counts,
                  fp64=dtype == torch.float32)


def _fp64_sums(x, w, dy, counts):
    """dx and dw summed in fp64, and gamma_n sum_i |a_i b_i| for each
    element (the module's note)."""
    e, c, k = x.shape
    f = w.shape[2]
    live = torch.arange(c, device=x.device)[None, :] < counts[:, None]
    xd, wd = x.double(), w.double()
    dyd = dy.double() * live[..., None]
    u = 2.0 ** -24
    n_dw = counts.clamp(max=c).double()[:, None, None]
    return (torch.einsum("ecf,ekf->eck", dyd, wd),
            torch.einsum("eck,ecf->ekf", xd, dyd),
            f * u / (1 - f * u) * torch.einsum("ecf,ekf->eck", dyd.abs(),
                                               wd.abs()),
            n_dw * u / (1 - n_dw * u) * torch.einsum(
                "eck,ecf->ekf", xd.abs(), dyd.abs()))


def _within(got, want64, bound):
    err = (got.double() - want64).abs()
    assert bool((err <= bound).all()), float((err - bound).max())


def _check_kernel(card, dtype, e, c, k, f, counts, fp64=False):
    x, w, dy, cn = _inputs(card, dtype, e, c, k, f, counts)
    n0, tc0 = gmod.LAUNCHES_BWD, gmod.LAUNCHES_BWD_TC
    dx, dw = gmod.moe_gmm_bwd(x, w, dy, cn)
    dx2, dw2 = gmod.moe_gmm_bwd(x, w, dy, cn)
    torch.cuda.synchronize()
    assert gmod.LAUNCHES_BWD == n0 + 2
    tc = dtype == torch.bfloat16 and k % 8 == 0 and f % 8 == 0
    assert gmod.LAUNCHES_BWD_TC == tc0 + 2 * tc
    assert gmod.bwd_instance(x, w, dy) == ("tc" if tc else "cuda_core")
    assert torch.equal(dx, dx2) and torch.equal(dw, dw2)
    rdx, rdw = moe_gmm_bwd_ref(x, w, dy, cn)
    if fp64:
        dx64, dw64, bdx, bdw = _fp64_sums(x, w, dy, cn)
        for got in (dx, rdx):
            _within(got, dx64, bdx)
        for got in (dw, rdw):
            _within(got, dw64, bdw)
    else:
        _close(dx, rdx, TOLS[dtype])
        _close(dw, rdw, TOLS[dtype])
    if cn is not None:
        for i, n in enumerate(cn.tolist()):
            assert bool((dx[i, n:] == 0).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("e,c,k,f,counts", SHAPES[2:])
def test_function_matches_autograd_of_the_plain_forward(card, dtype, e, c,
                                                         k, f, counts):
    _check_function(card, dtype, e, c, k, f, counts)


@pytest.mark.parametrize("e,c,k,f,counts", EDGES)
def test_function_on_tc_edges_matches_autograd(card, e, c, k, f, counts):
    _check_function(card, torch.bfloat16, e, c, k, f, counts)


def _check_function(card, dtype, e, c, k, f, counts):
    x, w, dy, cn = _inputs(card, dtype, e, c, k, f, counts)
    got, want = [], []
    for impl, out in (("kernel", got), ("plain", want)):
        xx = x.clone().requires_grad_()
        ww = w.clone().requires_grad_()
        if impl == "kernel":
            y = moe_gmm(xx, ww, cn, impl="kernel")
            assert "MoeGmmFn" in type(y.grad_fn).__name__
        else:
            y = moe_gmm_ref(xx, ww, cn)    # autograd through the einsum
        y.backward(dy)
        out += [y.detach(), xx.grad, ww.grad]
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        _close(a, b, TOLS[dtype])


RAGGED = (8, 200, 256, 136, [0, 200, 37, 1, 0, 150, 199, 64])


def test_bwd_graph_replay_equals_a_direct_call(card):
    """The tensor-core instance captured (its tensor maps encoded on the
    host at capture) and replayed after new values and new counts were
    copied into its inputs: the same bits as a direct call on them, and
    within the bf16 tolerance of the plain version."""
    bf = torch.bfloat16
    e, c, k, f, counts = RAGGED
    x, w, dy, cn = _inputs(card, bf, e, c, k, f, counts)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        gmod.moe_gmm_bwd(x, w, dy, cn)            # build and warm up
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    n0 = gmod.LAUNCHES_BWD_TC
    with torch.cuda.graph(graph, stream=side):
        dx, dw = gmod.moe_gmm_bwd(x, w, dy, cn)
    assert gmod.LAUNCHES_BWD_TC == n0 + 1
    x2, w2, dy2, _ = _inputs(card, bf, e, c, k, f, None, seed=7)
    x.copy_(x2)
    w.copy_(w2)
    dy.copy_(dy2)
    cn.copy_(torch.tensor([200, 0, 5, 199, 64, 65, 1, 128],
                          dtype=torch.int32))
    graph.replay()
    torch.cuda.synchronize()
    want_dx, want_dw = gmod.moe_gmm_bwd(x, w, dy, cn)
    torch.cuda.synchronize()
    assert torch.equal(dx, want_dx) and torch.equal(dw, want_dw)
    rdx, rdw = moe_gmm_bwd_ref(x, w, dy, cn)
    _close(dx, rdx, TOLS[bf])
    _close(dw, rdw, TOLS[bf])


def _moe_cfg():
    return dataclasses.replace(get_smoke("deepseek-moe-16b"), head_dim=64,
                               compute_dtype=torch.bfloat16)


def test_moe_train_step_graph_matches_eager(card):
    cfg = _moe_cfg()
    b, s = 4, 128
    opt = AdamWConfig(lr=1e-3)
    state = init_train_state(cfg, torch.Generator(card).manual_seed(0), card)
    counted = {}
    steps = {}
    for mode in ("graph", "eager"):
        for mod in (fa, gmod):
            mod.LAUNCHES = mod.LAUNCHES_TC = 0
            mod.LAUNCHES_BWD = mod.LAUNCHES_BWD_TC = 0
        steps[mode] = TrainStep(cfg, opt, state, b, s, step_impl=mode)
        counted[mode] = (gmod.LAUNCHES, gmod.LAUNCHES_TC, gmod.LAUNCHES_BWD,
                         gmod.LAUNCHES_BWD_TC, fa.LAUNCHES_BWD_TC)
    pipe = DataPipeline(cfg.vocab_size, b, s, seed=3)
    for _ in range(3):
        batch = {k: torch.from_numpy(v) for k, v in next(pipe).items()}
        mg, me = steps["graph"](batch), steps["eager"](batch)
        torch.cuda.synchronize()
        assert mg.keys() == me.keys() >= {"xent", "aux"}
        for k in mg:
            assert torch.equal(mg[k], me[k]), k
        assert float(mg["aux"]) > 0
        for i, (a, e) in enumerate(zip(flatten(steps["graph"].state)[0],
                                       flatten(steps["eager"].state)[0])):
            assert torch.equal(a, e), i
    g, e = steps["graph"].graph, steps["eager"].graph
    assert (g.captures, g.replays, g.calls) == (1, 3, WARMUP + 1)
    n_moe = cfg.num_layers - cfg.first_k_dense
    # per direct call: 3 forwards per MoE layer, again under remat, and 3
    # backward calls, all on the tensor cores; flash's backward too
    for mode, calls in (("graph", WARMUP + 1), ("eager", 1)):
        fwd, fwd_tc, bwd, bwd_tc, fa_bwd_tc = counted[mode]
        assert fwd == fwd_tc == 3 * n_moe * 2 * calls, mode
        assert bwd == bwd_tc == 3 * n_moe * calls, mode
        assert fa_bwd_tc == cfg.num_layers * calls, mode
    assert e.calls == 1 + 3
