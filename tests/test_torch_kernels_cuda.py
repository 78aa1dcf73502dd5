"""Card-only: each CUDA kernel against its plain version on the card
(attention also at deepseek-moe-16b's head shape, d 128 with one query
head per kv head, and recurrentgemma-2b's, d 256 with a group of 10;
non-causal with fewer or more queries than keys at whisper-medium's
heads, the encoder's 1500 states and its cross-attention, forward and
backward, and the backward at llava-next-mistral-7b's training shape;
paged attention also at 16 pages a row, where a row's pages are split
over blocks and merged in the launch, with windows across splits and a
group of 8; the grouped matmul at ragged and deepseek shapes, also with
per-expert row counts; both scans at their models' widths, ragged
lengths and a nonzero initial state, the WKV also at the model's full
decay range and on views whose rows are not 16-byte aligned), which
instance of flash attention (forward and backward) and the grouped
matmul ran (the tensor cores' for bf16 at the shapes they take, the CUDA
cores' otherwise), that the tensor-core instances, the flash backward,
paged attention and the WKV give bit-identical output call after call,
and both executors on the card against the same executor on the host.

The kernels have no CPU mode, so every test here carries the ``cuda``
marker and skips without a card.  On a machine with one:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_kernels_cuda.py

Tolerances: fp32 atol/rtol 1e-5 (the same fp32 arithmetic in another
order; TF32 is off); bf16 atol 1.6e-2, rtol 1e-2 — both sides compute in
fp32 and round once to bf16, so they differ by at most one bf16 ulp,
2^-6 = 0.0156 for outputs below 4 in magnitude.  The RWKV-6 state sums
hundreds of outer products (entries up to ~100), so its fp32 outputs and
states are held to atol/rtol 1e-4 (the CPU parity bound).  The flash
backward's bounds are set out at ``BWD_TOLS``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attention import \
    flash_attention as fmod  # noqa: E402
from repro_torch.kernels.flash_attention.ops import \
    flash_attention_bshd  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    attention_bwd_ref, attention_ref)
from repro_torch.kernels.moe_gmm import moe_gmm as gmod  # noqa: E402
from repro_torch.kernels.moe_gmm.ref import moe_gmm_ref  # noqa: E402
from repro_torch.kernels.paged_attention import \
    paged_attention as pmod  # noqa: E402
from repro_torch.kernels.paged_attention.ref import \
    paged_attention_ref  # noqa: E402
from repro_torch.kernels.rglru_scan import rglru_scan as smod  # noqa: E402
from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref  # noqa: E402
from repro_torch.kernels.rwkv6_wkv import rwkv6_wkv as wmod  # noqa: E402
from repro_torch.kernels.rwkv6_wkv.ref import rwkv6_wkv_ref  # noqa: E402

pytestmark = pytest.mark.cuda

TOLS = {torch.float32: dict(atol=1e-5, rtol=1e-5),
        torch.bfloat16: dict(atol=1.6e-2, rtol=1e-2)}


@pytest.fixture(autouse=True)
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels have no CPU mode")
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = saved


def _close(out, ref, dtype):
    torch.cuda.synchronize()
    np.testing.assert_allclose(out.float().cpu().numpy(),
                               ref.float().cpu().numpy(), **TOLS[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("b,hq,hkv,sq,d,window", [
    (1, 9, 3, 1, 64, 0), (1, 9, 3, 127, 64, 0), (1, 9, 3, 129, 64, 0),
    (1, 9, 3, 300, 64, 0), (1, 9, 3, 300, 64, 100), (2, 3, 1, 77, 16, 0),
    (2, 4, 2, 150, 32, 40), (1, 10, 2, 200, 128, 0),
    (1, 16, 16, 129, 128, 0), (1, 16, 16, 300, 128, 0),
    (1, 10, 1, 300, 256, 0), (1, 10, 1, 300, 256, 100),
    (2, 10, 1, 65, 256, 0),
    # granite-3-8b's heads (d 128, group 4): the continuous engine's
    # batch-1 prefills and the static engine's batch-8 one
    (1, 32, 8, 1, 128, 0), (1, 32, 8, 129, 128, 0), (1, 32, 8, 300, 128, 0),
    (8, 32, 8, 200, 128, 0),
    # the static engine's batch-8 prefills of smollm-135m and
    # recurrentgemma-2b (its 2048 window, as the model passes it)
    (8, 9, 3, 200, 64, 0), (8, 10, 1, 200, 256, 2048)])
def test_flash_kernel_matches_plain(card, dtype, b, hq, hkv, sq, d, window):
    g = torch.Generator(device=card).manual_seed(sq + d)
    q, k, v = (torch.randn((b, s, h, d), generator=g, device=card).to(dtype)
               for s, h in ((sq, hq), (sq, hkv), (sq, hkv)))
    n0, tc0 = fmod.LAUNCHES, fmod.LAUNCHES_TC
    out = flash_attention_bshd(q, k, v, window=window, impl="auto")
    assert fmod.LAUNCHES == n0 + 1
    # bf16 at head_dim 64 / 128 / 256 runs on the tensor cores
    tc = dtype == torch.bfloat16 and d in fmod.TC_HEAD_DIMS
    assert fmod.LAUNCHES_TC == tc0 + tc
    ref = flash_attention_bshd(q, k, v, window=window, impl="ref")
    _close(out, ref, dtype)
    # contiguous (b, h, s, d) inputs straight into the kernel
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    _close(fmod.flash_attention(qt, kt, vt, window=window),
           attention_ref(qt, kt, vt, window=window), dtype)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("d,hq,hkv", [(64, 9, 3), (128, 16, 16),
                                     (128, 32, 8), (256, 10, 1)])
@pytest.mark.parametrize("sq,window", [(1, 0), (127, 0), (129, 0), (300, 0),
                                       (300, 100)])
def test_flash_tc_kernel_matches_plain(card, d, hq, hkv, sq, window, causal):
    """The tensor-core instance (bf16) at every head_dim it takes, at a
    single token, around a tile edge, at a prompt length and with a
    window, causal or not; two calls are bit-identical."""
    dtype = torch.bfloat16
    g = torch.Generator(device=card).manual_seed(sq + d + window)
    q, k, v = (torch.randn((1, s, h, d), generator=g, device=card).to(dtype)
               for s, h in ((sq, hq), (sq, hkv), (sq, hkv)))
    kw = dict(causal=causal, window=window)
    tc0 = fmod.LAUNCHES_TC
    out = flash_attention_bshd(q, k, v, impl="kernel", **kw)
    again = flash_attention_bshd(q, k, v, impl="kernel", **kw)
    assert fmod.LAUNCHES_TC == tc0 + 2
    _close(out, flash_attention_bshd(q, k, v, impl="ref", **kw), dtype)
    assert torch.equal(out, again)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("b,sq,skv", [
    (1, 1, 1500), (1, 200, 1500), (1, 1500, 1500),    # whisper-medium
    (1, 1, 1499), (1, 200, 1499), (1, 64, 1),          # ragged key counts
    (8, 1500, 1500), (8, 1, 1500), (8, 200, 1500)])    # the static server
def test_flash_noncausal_cross_matches_plain(card, dtype, b, sq, skv):
    """Non-causal attention with sq != skv, at whisper-medium's heads (16
    of 64, MHA): one decode query or a 200-token prompt against the
    encoder's 1500 states (cross-attention), the encoder's own 1500, and
    key counts that end inside a 128-key tile, at batch 1 and at the
    static server's 8; in both instances (bf16 on the tensor cores), two
    calls bit-identical."""
    g = torch.Generator(device=card).manual_seed(sq + skv)
    q, k, v = (torch.randn((b, s, 16, 64), generator=g, device=card)
               .to(dtype) for s in (sq, skv, skv))
    n0, tc0 = fmod.LAUNCHES, fmod.LAUNCHES_TC
    out = flash_attention_bshd(q, k, v, causal=False, impl="kernel")
    again = flash_attention_bshd(q, k, v, causal=False, impl="kernel")
    assert fmod.LAUNCHES == n0 + 2
    assert fmod.LAUNCHES_TC == tc0 + 2 * (dtype == torch.bfloat16)
    _close(out, flash_attention_bshd(q, k, v, causal=False, impl="ref"),
           dtype)
    assert torch.equal(out, again)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    _close(fmod.flash_attention(qt, kt, vt, causal=False),
           attention_ref(qt, kt, vt, causal=False), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("hq,hkv,d,sq", [
    (16, 16, 64, 200),                 # whisper-medium's decoder
    (32, 8, 128, 1152 + 200)])         # llava: 1152 patches + 200 tokens
def test_flash_static_batch_causal_matches_plain(card, dtype, hq, hkv, d,
                                                 sq):
    """The static server's causal prefills at its batch of 8: whisper-
    medium's decoder self-attention over 200 tokens and llava-next-
    mistral-7b's over 1352 positions; in both instances (bf16 on the
    tensor cores), two calls bit-identical."""
    g = torch.Generator(device=card).manual_seed(sq + d)
    q, k, v = (torch.randn((8, sq, h, d), generator=g, device=card)
               .to(dtype) for h in (hq, hkv, hkv))
    n0, tc0 = fmod.LAUNCHES, fmod.LAUNCHES_TC
    out = flash_attention_bshd(q, k, v, causal=True, impl="kernel")
    again = flash_attention_bshd(q, k, v, causal=True, impl="kernel")
    assert fmod.LAUNCHES == n0 + 2
    assert fmod.LAUNCHES_TC == tc0 + 2 * (dtype == torch.bfloat16)
    _close(out, flash_attention_bshd(q, k, v, causal=True, impl="ref"),
           dtype)
    assert torch.equal(out, again)


# the backward's dq / dk sum thousands of products (dk and dv over every
# query row of a group) in another order than the plain version's
# einsums: fp32 is held to 1e-4.  The bf16 (tensor-core) instance rounds
# P and dS to bf16 as the operands of their products, as SDPA's backward
# does: it is held to the plain version with the same rounding
# (``operand_dtype=torch.bfloat16``), both sides' fp32 results rounded
# once to bf16, one ulp apart at most; and its relative distance from
# the fp32 plain backward on the same (upcast) inputs to BWD_DIST_FACTOR
# times that rounding model's own.  Where the model's distance is 0 the
# fp32 gradient is itself a cancellation down to fp32 noise (dq and dk of
# rows that see one key: P = 1, dP = D), which no ratio can hold; there
# the tolerance alone holds the kernel
BWD_TOLS = {torch.float32: dict(atol=1e-4, rtol=1e-4),
            torch.bfloat16: TOLS[torch.bfloat16]}
BWD_DIST_FACTOR = 2.0


def _bwd_inputs(dev, dtype, b, hq, hkv, sq, d, seed, skv=None):
    """The model's (b, s, h, d) q, k, v and an output gradient, viewed as
    (b, h, s, d); k and v hold ``skv`` positions (default sq)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v, do = (torch.randn((b, s, h, d), generator=g, device=dev)
                   .to(dtype).transpose(1, 2)
                   for s, h in ((sq, hq), (skv or sq, hkv), (skv or sq, hkv),
                                (sq, hq)))
    return q, k, v, do


def _rel_dist(a, b):
    a, b = a.float(), b.float()
    return (torch.linalg.vector_norm(a - b)
            / torch.linalg.vector_norm(b).clamp_min(1e-30)).item()


def _check_bwd(out, args, kw, tc):
    """dq, dk, dv of the kernel against the plain backward: the CUDA-core
    instance as it is; the tensor-core one (``tc``) against the rounding
    model, and within BWD_DIST_FACTOR times its distance from the fp32
    plain backward."""
    torch.cuda.synchronize()
    dtype = args[0].dtype
    ref = attention_bwd_ref(*args, **kw, operand_dtype=(
        torch.bfloat16 if tc else None))
    for a, r, t, name in zip(out, ref, args[:3], ("dq", "dk", "dv")):
        assert a.dtype == dtype and a.stride() == t.stride(), name
        np.testing.assert_allclose(a.float().cpu().numpy(),
                                   r.float().cpu().numpy(), err_msg=name,
                                   **BWD_TOLS[dtype])
    if tc:
        exact = attention_bwd_ref(*(t.float() for t in args), **kw)
        for a, r, x, name in zip(out, ref, exact, ("dq", "dk", "dv")):
            floor = _rel_dist(r, x)
            if floor > 0:
                assert _rel_dist(a, x) <= BWD_DIST_FACTOR * floor, name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("b,hq,hkv,sq,d,causal,window", [
    (2, 9, 3, 300, 64, True, 0),       # smollm-135m's heads, ragged
    (1, 9, 3, 129, 64, True, 0),       # one past a tile
    (1, 9, 3, 1, 64, True, 0),
    (2, 4, 2, 200, 64, True, 48),      # sliding window across tiles
    (1, 6, 2, 77, 64, False, 30),      # window without the causal mask
    (1, 8, 8, 256, 128, True, 0),      # d 128, g 1
    (1, 4, 4, 150, 128, False, 0),     # d 128, no mask
    # chip_smoke.py's cases: smollm's training shape, d 128 with g 1 at
    # 1024 tokens, a window, a length no tile divides
    (8, 9, 3, 2048, 64, True, 0), (2, 16, 16, 1024, 128, True, 0),
    (4, 9, 3, 1024, 64, True, 256), (2, 9, 3, 1000, 64, True, 0),
    # head_dim 256, recurrentgemma-2b's MQA (group 10): a ragged length,
    # a window across tiles one past a tile, no mask with g 1, and its
    # training shape (4096 tokens, window 2048)
    (1, 10, 1, 300, 256, True, 0), (1, 10, 1, 129, 256, True, 48),
    (2, 4, 4, 150, 256, False, 0), (1, 10, 1, 4096, 256, True, 2048),
    # d 256 groups split unevenly over the dK / dV blocks (g 3 over 2,
    # g 10 over 7: ``bwd_splits``), and batch 2 with two kv heads at a
    # ragged length with the window
    (1, 6, 2, 4480, 256, True, 1024), (1, 10, 1, 2560, 256, True, 512),
    (2, 4, 2, 333, 256, True, 100),
])
def test_flash_bwd_kernel_matches_plain(card, dtype, b, hq, hkv, sq, d,
                                        causal, window):
    """dq, dk, dv of the backward kernel against ``attention_bwd_ref`` on
    the same (q, k, v, o, lse, do) (``_check_bwd``); bf16 runs on the
    tensor cores, fp32 on the CUDA cores; two calls bit-identical (no
    atomics); one count per call."""
    q, k, v, do = _bwd_inputs(card, dtype, b, hq, hkv, sq, d,
                              seed=sq + d + window)
    kw = dict(causal=causal, window=window)
    o, lse = attention_ref(q, k, v, return_lse=True, **kw)
    tc = dtype == torch.bfloat16
    assert fmod.bwd_instance(q, k, v, o, do) == ("tc" if tc else "cuda_core")
    n0, tc0 = fmod.LAUNCHES_BWD, fmod.LAUNCHES_BWD_TC
    out = fmod.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    again = fmod.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    assert fmod.LAUNCHES_BWD == n0 + 2
    assert fmod.LAUNCHES_BWD_TC == tc0 + 2 * tc
    _check_bwd(out, (q, k, v, o, lse, do), kw, tc)
    assert all(torch.equal(a, b) for a, b in zip(out, again))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("b,hq,hkv,sq,skv,d,causal", [
    # chip_smoke.py's training shapes of whisper-medium and
    # llava-next-mistral-7b at a reduced batch: the encoder (1500 keys:
    # 11 x 128 + 92, 23 x 64 + 28), the cross-attention (448 = 3 x 128 +
    # 64 queries against them), the decoder's causal self-attention, and
    # llava's GQA group 4 at d 128 over 4096 positions
    (2, 16, 16, 1500, 1500, 64, False), (2, 16, 16, 448, 1500, 64, False),
    (2, 16, 16, 448, 448, 64, True), (1, 32, 8, 4096, 4096, 128, True),
    # more queries than keys, non-causal, ragged, g 1 and g 4
    (2, 4, 4, 200, 70, 64, False), (1, 8, 2, 100, 60, 128, False),
])
def test_flash_bwd_noncausal_and_train_shapes_match_plain(
        card, dtype, b, hq, hkv, sq, skv, d, causal):
    """The backward at sq != skv without the causal mask, and at the
    enc-dec and vlm training shapes, against ``attention_bwd_ref``
    (``_check_bwd``): bf16 on the tensor cores, two calls bit-identical,
    one count per call."""
    q, k, v, do = _bwd_inputs(card, dtype, b, hq, hkv, sq, d,
                              seed=sq + skv + d, skv=skv)
    kw = dict(causal=causal)
    o, lse = attention_ref(q, k, v, return_lse=True, **kw)
    tc = dtype == torch.bfloat16
    assert fmod.bwd_instance(q, k, v, o, do) == ("tc" if tc else "cuda_core")
    n0, tc0 = fmod.LAUNCHES_BWD, fmod.LAUNCHES_BWD_TC
    out = fmod.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    again = fmod.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    assert fmod.LAUNCHES_BWD == n0 + 2
    assert fmod.LAUNCHES_BWD_TC == tc0 + 2 * tc
    _check_bwd(out, (q, k, v, o, lse, do), kw, tc)
    assert all(torch.equal(a, b) for a, b in zip(out, again))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_flash_bwd_d256_graph_replay_equals_direct_call(card, dtype):
    """At d 256 (four launches on the tensor cores, three on the CUDA
    cores, a workspace allocated by the wrapper) a CUDA-graph replay of
    the backward gives the direct call's bits, and two replays agree."""
    q, k, v, do = _bwd_inputs(card, dtype, 1, 10, 1, 700, 256, seed=5)
    kw = dict(causal=True, window=300)
    o, lse = attention_ref(q, k, v, return_lse=True, **kw)
    direct = fmod.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fmod.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        out = fmod.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(out, direct))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_flash_bwd_d256_rows_that_see_no_key(card, dtype):
    """Query rows past skv + window see no key (causal, 300 queries on
    100 keys, window 64): their dq is exactly zero and every gradient
    finite; the rest matches the plain backward (``_check_bwd``)."""
    b, hq, hkv, sq, skv, d = 1, 10, 1, 300, 100, 256
    g = torch.Generator(device=card).manual_seed(9)
    q, do = (torch.randn((b, sq, hq, d), generator=g, device=card)
             .to(dtype).transpose(1, 2) for _ in range(2))
    k, v = (torch.randn((b, skv, hkv, d), generator=g, device=card)
            .to(dtype).transpose(1, 2) for _ in range(2))
    kw = dict(causal=True, window=64)
    o, lse = attention_ref(q, k, v, return_lse=True, **kw)
    out = fmod.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    assert all(bool(torch.isfinite(t.float()).all()) for t in out)
    blind = skv + 64 - 1                  # the first row that sees no key
    assert not bool(out[0][:, :, blind:].float().abs().max())
    assert bool(out[0][:, :, :blind].float().abs().max())
    _check_bwd(out, (q, k, v, o, lse, do), kw, dtype == torch.bfloat16)


def test_flash_bwd_misaligned_bf16_runs_on_cuda_cores(card):
    """A bf16 q whose rows are not 16-byte aligned (a view 4 elements
    into its storage) takes the CUDA-core instance, which matches the
    plain backward without operand rounding."""
    b, hq, hkv, sq, d = 1, 9, 3, 200, 64
    _, k, v, do = _bwd_inputs(card, torch.bfloat16, b, hq, hkv, sq, d,
                              seed=11)
    g = torch.Generator(device=card).manual_seed(12)
    flat = torch.randn(b * sq * hq * d + 4, generator=g, device=card)
    q = flat.to(torch.bfloat16)[4:].view(b, sq, hq, d).transpose(1, 2)
    o, lse = attention_ref(q, k, v, return_lse=True)
    assert fmod.bwd_instance(q, k, v, o, do) == "cuda_core"
    n0, tc0 = fmod.LAUNCHES_BWD, fmod.LAUNCHES_BWD_TC
    out = fmod.flash_attention_bwd(q, k, v, o, lse, do)
    assert (fmod.LAUNCHES_BWD, fmod.LAUNCHES_BWD_TC) == (n0 + 1, tc0)
    _check_bwd(out, (q, k, v, o, lse, do), dict(causal=True, window=0),
               tc=False)


def test_flash_bwd_misaligned_bf16_d256_runs_on_cuda_cores(card):
    """The same at d 256 (the CUDA-core kernels' d-256 tiles and group
    split with bf16 staged as fp32), a group of 10 over 10 splits."""
    b, hq, hkv, sq, d = 1, 10, 1, 700, 256
    _, k, v, do = _bwd_inputs(card, torch.bfloat16, b, hq, hkv, sq, d,
                              seed=13)
    g = torch.Generator(device=card).manual_seed(14)
    flat = torch.randn(b * sq * hq * d + 4, generator=g, device=card)
    q = flat.to(torch.bfloat16)[4:].view(b, sq, hq, d).transpose(1, 2)
    kw = dict(causal=True, window=300)
    o, lse = attention_ref(q, k, v, return_lse=True, **kw)
    assert fmod.bwd_instance(q, k, v, o, do) == "cuda_core"
    assert fmod.bwd_splits(b, hq, hkv, sq, d) == 10
    out = fmod.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    again = fmod.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    _check_bwd(out, (q, k, v, o, lse, do), kw, tc=False)
    assert all(torch.equal(x, y) for x, y in zip(out, again))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_flash_autograd_on_card_matches_plain(card, dtype):
    """The autograd Function on CUDA tensors (forward kernel with LSE,
    backward kernel) against the same Function on the plain versions
    (impl="ref"), through ``flash_attention_bshd``."""
    q, k, v, do = (t.transpose(1, 2) for t in _bwd_inputs(
        card, dtype, 2, 9, 3, 200, 64, seed=3))
    grads = {}
    for impl in ("kernel", "ref"):
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        o = flash_attention_bshd(*leaves, window=64, impl=impl)
        grads[impl] = torch.autograd.grad(o, leaves, do)
    # the tensor-core forward rounds P to bf16 and sums the rounded P
    # into its LSE: the gradients land within bf16 resolution of the
    # plain ones
    tol = BWD_TOLS[dtype] if dtype == torch.float32 else dict(atol=5e-2,
                                                              rtol=5e-2)
    for a, r in zip(grads["kernel"], grads["ref"]):
        torch.cuda.synchronize()
        np.testing.assert_allclose(a.float().cpu().numpy(),
                                   r.float().cpu().numpy(), **tol)


@pytest.mark.parametrize("d", [32, 96])
def test_flash_bwd_kernel_refuses_other_head_dims(card, d):
    q, k, v, do = _bwd_inputs(card, torch.bfloat16, 1, 4, 2, 64, d, seed=1)
    o, lse = attention_ref(q, k, v, return_lse=True)
    with pytest.raises(ValueError, match="head_dim"):
        fmod.flash_attention_bwd(q, k, v, o, lse, do)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention_bshd(*(t.transpose(1, 2).requires_grad_()
                               for t in (q, k, v)), impl="kernel")


@pytest.mark.parametrize("dtype,d", [(torch.float32, 64),
                                     (torch.bfloat16, 64),
                                     (torch.bfloat16, 128),
                                     (torch.bfloat16, 256),
                                     (torch.bfloat16, 32)],
                         ids=["fp32-d64", "tc-d64", "tc-d128", "tc-d256",
                              "bf16-cuda-core-d32"])
@pytest.mark.parametrize("window", [0, 50])
def test_flash_lse_and_output_unchanged_by_lse(card, dtype, d, window):
    """Both forward instances: the LSE against the plain LSE (fp32 1e-5;
    the tensor-core instance sums bf16-rounded probabilities, 1e-2), and
    the output is the same bit for bit with the LSE pointer null or
    set."""
    q, k, v, _ = _bwd_inputs(card, dtype, 2, 8, 2, 300, d, seed=d + window)
    plain_o, plain_lse = attention_ref(q, k, v, window=window,
                                       return_lse=True)
    out0 = fmod.flash_attention(q, k, v, window=window)
    out1, lse = fmod.flash_attention(q, k, v, window=window, return_lse=True)
    torch.cuda.synchronize()
    assert torch.equal(out0, out1)
    tol = (dict(atol=1e-5, rtol=1e-5) if fmod.instance(q, k, v) != "tc"
           else dict(atol=1e-2, rtol=1e-3))
    np.testing.assert_allclose(lse.cpu().numpy(), plain_lse.cpu().numpy(),
                               **tol)


def _paged_inputs(dev, dtype, b, hq, hkv, d, bt, nb, lengths, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    n_pages = b * nb + 1
    q = torch.randn((b, hq, d), generator=g, device=dev).to(dtype)
    kp = torch.randn((hkv, n_pages, bt, d), generator=g, device=dev).to(dtype)
    vp = torch.randn((hkv, n_pages, bt, d), generator=g, device=dev).to(dtype)
    rng = np.random.default_rng(seed)
    tables = rng.permutation(b * nb).reshape(b, nb).astype(np.int32)
    for r, n in enumerate(lengths):
        tables[r, -(-n // bt):] = n_pages - 1          # null-page tail
    return (q, kp, vp, torch.from_numpy(tables).to(dev),
            torch.tensor(lengths, dtype=torch.int32, device=dev))


LONG = [0, 1, 129, 700, 1000, 1500, 2047, 2048]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("b,hq,hkv,d,bt,nb,window,lengths", [
    (8, 9, 3, 64, 128, 3, 0, [0, 1, 127, 128, 129, 200, 300, 384]),
    (8, 9, 3, 64, 128, 3, 100, [0, 1, 127, 128, 129, 200, 300, 384]),
    (4, 3, 1, 16, 16, 3, 0, [48, 0, 17, 1]),
    (3, 10, 2, 128, 64, 4, 70, [256, 3, 130]),
    (8, 16, 16, 128, 128, 3, 0, [0, 1, 127, 128, 129, 200, 300, 364]),
    # many splits: 16 pages a row, one split each
    (8, 9, 3, 64, 128, 16, 0, LONG),
    # a window of 300 that crosses split (page) boundaries
    (8, 9, 3, 64, 128, 16, 300, LONG),
    # a group of 8 query heads per kv head
    (4, 16, 2, 64, 128, 4, 0, [0, 5, 300, 512]),
    # deepseek's heads at 16 pages: 2,048 blocks, so two pages a split
    (8, 16, 16, 128, 128, 16, 0, LONG),
    (8, 16, 16, 128, 128, 16, 200, LONG),
    # granite-3-8b's heads (d 128, group 4) at the serving lengths
    (8, 32, 8, 128, 128, 3, 0, [0, 1, 127, 128, 129, 200, 300, 364]),
    (8, 32, 8, 128, 128, 16, 0, LONG),
])
def test_paged_kernel_matches_plain(card, dtype, b, hq, hkv, d, bt, nb,
                                    window, lengths):
    """Every case against the plain version; inactive rows are exact
    zeros and two calls (split merge included) are bit-identical."""
    args = _paged_inputs(card, dtype, b, hq, hkv, d, bt, nb, lengths,
                         seed=b + d + bt)
    n0 = pmod.LAUNCHES
    out = pmod.paged_attention(*args, window=window)
    again = pmod.paged_attention(*args, window=window)
    assert pmod.LAUNCHES == n0 + 2
    ref = paged_attention_ref(*args, window=window)
    _close(out, ref, dtype)
    assert torch.equal(out, again)
    zero = [i for i, n in enumerate(lengths) if n == 0]
    assert torch.all(out[zero] == 0)


def test_paged_kernel_tickets_per_stream_and_in_graphs(card):
    """The split merge's tickets: a call on a second stream and a graph
    captured there and replayed give the eager call's output bit for
    bit; a width past MAX_TICKETS is refused."""
    args = _paged_inputs(card, torch.bfloat16, 8, 9, 3, 64, 128, 16, LONG,
                         seed=7)
    eager = pmod.paged_attention(*args)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        on_side = pmod.paged_attention(*args)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        captured = pmod.paged_attention(*args)
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(captured, eager)
    assert torch.equal(on_side, eager)
    q = torch.zeros((pmod.MAX_TICKETS + 1, 1, 16), device=card)
    pages = torch.zeros((1, 1, 16, 16), device=card)
    with pytest.raises(ValueError, match="unsupported shapes"):
        pmod.paged_attention(q, pages, pages,
                             torch.zeros((len(q), 1), dtype=torch.int32,
                                         device=card),
                             torch.zeros(len(q), dtype=torch.int32,
                                         device=card))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("e,c,k,f", [
    (4, 24, 64, 44), (3, 5, 37, 19), (2, 130, 100, 70),
    (64, 24, 2048, 1408), (64, 48, 2048, 1408), (64, 48, 1408, 2048)])
def test_moe_gmm_kernel_matches_plain(card, dtype, e, c, k, f):
    g = torch.Generator(device=card).manual_seed(e + c + k + f)
    x = torch.randn((e, c, k), generator=g, device=card).to(dtype)
    w = (torch.randn((e, k, f), generator=g, device=card)
         * k ** -0.5).to(dtype)
    n0, tc0 = gmod.LAUNCHES, gmod.LAUNCHES_TC
    out = gmod.moe_gmm(x, w)
    assert gmod.LAUNCHES == n0 + 1
    # bf16 with K and F multiples of 8 runs on the tensor cores
    tc = dtype == torch.bfloat16 and k % 8 == 0 and f % 8 == 0
    assert gmod.LAUNCHES_TC == tc0 + tc
    assert out.dtype == dtype and tuple(out.shape) == (e, c, f)
    _close(out, moe_gmm_ref(x, w), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("e,c,k,f", [
    (4, 24, 64, 44), (5, 130, 96, 72), (64, 48, 2048, 1408),
    (64, 48, 1408, 2048)])
def test_moe_gmm_kernel_with_counts(card, dtype, e, c, k, f):
    """``counts`` with an empty expert and a full one: the output equals
    the plain version's and, bit for bit, the kernel's own without
    counts on the same zero-padded x; two calls are bit-identical."""
    g = torch.Generator(device=card).manual_seed(e * c + k)
    counts = torch.randint(0, c + 1, (e,), generator=g, device=card,
                           dtype=torch.int32)
    counts[0], counts[-1] = 0, c
    x = torch.randn((e, c, k), generator=g, device=card).to(dtype)
    x *= (torch.arange(c, device=card)[None, :] < counts[:, None])[..., None]
    w = (torch.randn((e, k, f), generator=g, device=card)
         * k ** -0.5).to(dtype)
    n0 = gmod.LAUNCHES
    out = gmod.moe_gmm(x, w, counts)
    again = gmod.moe_gmm(x, w, counts)
    assert gmod.LAUNCHES == n0 + 2
    _close(out, moe_gmm_ref(x, w, counts), dtype)
    assert torch.equal(out, again)
    assert torch.equal(out, gmod.moe_gmm(x, w))
    assert bool((out[0] == 0).all())


@pytest.mark.parametrize("e,c,k,f", [(64, 48, 2048, 1408), (3, 17, 88, 40)])
def test_moe_gmm_tc_is_deterministic(card, e, c, k, f):
    g = torch.Generator(device=card).manual_seed(c + f)
    x = torch.randn((e, c, k), generator=g, device=card).bfloat16()
    w = (torch.randn((e, k, f), generator=g, device=card)
         * k ** -0.5).bfloat16()
    tc0 = gmod.LAUNCHES_TC
    outs = [gmod.moe_gmm(x, w) for _ in range(3)]
    assert gmod.LAUNCHES_TC == tc0 + 3
    assert all(torch.equal(outs[0], o) for o in outs[1:])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("batch,seq,ch,with_h0", [
    (1, 300, 2560, False), (1, 300, 2560, True), (3, 37, 200, True),
    (2, 1, 64, False), (1, 2048, 2560, False), (1, 40, 2560, True),
    (2, 45, 100, True), (1, 33, 70, False), (4, 300, 2560, True),
    (8, 200, 2560, False)])
def test_rglru_scan_kernel_matches_plain(card, dtype, batch, seq, ch,
                                         with_h0):
    """recurrentgemma-2b's width at 300 and 2048 steps (the ring wraps
    many times), lengths that are no multiple of the 32-step chunk,
    widths that are no multiple of the channel group (ch 70: rows not
    16-byte aligned, staged element by element), batch 4; fp32 is
    bit-exact (the plain version rounds the same two ops)."""
    g = torch.Generator(device=card).manual_seed(seq + ch)
    a = torch.rand((batch, seq, ch), generator=g, device=card).to(dtype)
    b = torch.randn((batch, seq, ch), generator=g, device=card).to(dtype)
    h0 = (torch.randn((batch, ch), generator=g, device=card)
          if with_h0 else None)
    n0 = smod.LAUNCHES
    out = smod.rglru_scan(a, b, h0)
    assert smod.LAUNCHES == n0 + 1
    assert out.dtype == dtype and out.shape == a.shape
    ref = rglru_scan_ref(a, b, h0)
    _close(out, ref, dtype)
    if dtype == torch.float32:
        assert torch.equal(out, ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("batch,seq,ch", [(1, 70, 256), (2, 33, 2560)])
def test_rglru_scan_kernel_unaligned_views(card, dtype, batch, seq, ch):
    """Contiguous views one element past an aligned start (so no row is
    16-byte aligned) take the element-by-element staging."""
    g = torch.Generator(device=card).manual_seed(seq + ch + 1)
    n = batch * seq * ch

    def view(x):
        return x.to(dtype)[1:n + 1].view(batch, seq, ch)

    a = view(torch.rand(n + 1, generator=g, device=card))
    b = view(torch.randn(n + 1, generator=g, device=card))
    assert a.is_contiguous() and a.data_ptr() % 16
    out = smod.rglru_scan(a, b)
    ref = rglru_scan_ref(a, b)
    _close(out, ref, dtype)
    if dtype == torch.float32:
        assert torch.equal(out, ref)


def test_rglru_scan_graph_replay_is_bit_identical(card):
    """A CUDA-graph replay of the scan gives the eager call's output."""
    g = torch.Generator(device=card).manual_seed(5)
    a = torch.rand((1, 300, 2560), generator=g, device=card)
    b = torch.randn((1, 300, 2560), generator=g, device=card)
    h0 = torch.randn((1, 2560), generator=g, device=card)
    eager = smod.rglru_scan(a, b, h0)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        smod.rglru_scan(a, b, h0)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        out = smod.rglru_scan(a, b, h0)
    out.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)


def _wkv_inputs(dev, dtype, b, s, h, n, with_s0, decay, pad=0):
    """The model's layout: (b, s, h*n) projections viewed as (b, s, h, n);
    ``pad`` > 0 cuts the views from rows ``pad`` elements wider at offset
    ``pad``, so no row is 16-byte aligned.  logw = -exp(x) with x uniform
    in ``decay``."""
    g = torch.Generator(device=dev).manual_seed(s + h + n)

    def proj(scale):
        x = torch.randn((b, s, h * n + pad), generator=g, device=dev)
        return (x * scale).to(dtype)[..., pad:].unflatten(-1, (h, n))

    r, k, v = (proj(0.5) for _ in range(3))
    lo, hi = decay
    x = torch.empty((b, s, h * n + pad), device=dev).uniform_(lo, hi,
                                                              generator=g)
    logw = (-torch.exp(x)).to(dtype)[..., pad:].unflatten(-1, (h, n))
    u = torch.randn((h, n), generator=g, device=dev) * 0.1
    s0 = (torch.randn((b, h, n, n), generator=g, device=dev)
          if with_s0 else None)
    return r, k, v, logw, u, s0


def _wkv_check(args, dtype):
    """Kernel vs plain version (output and final state), two calls
    bit-identical, one launch a call."""
    n0 = wmod.LAUNCHES
    o, st = wmod.rwkv6_wkv(*args)
    o2, st2 = wmod.rwkv6_wkv(*args)
    assert wmod.LAUNCHES == n0 + 2
    o_ref, st_ref = rwkv6_wkv_ref(*args)
    tol = TOLS[dtype] if dtype == torch.bfloat16 else dict(atol=1e-4,
                                                           rtol=1e-4)
    torch.cuda.synchronize()
    np.testing.assert_allclose(o.float().cpu().numpy(),
                               o_ref.float().cpu().numpy(), **tol)
    np.testing.assert_allclose(st.cpu().numpy(), st_ref.cpu().numpy(),
                               atol=1e-4, rtol=1e-4)
    assert torch.equal(o, o2) and torch.equal(st, st2)


# the decay ranges: the card cases' usual one, and the model's full one
# (logw = -exp(clamp(dd, -20, 10)), models/rwkv.py)
DECAYS = {"usual": (-6.0, -1.0), "full": (-20.0, 10.0)}


@pytest.mark.parametrize("decay", sorted(DECAYS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("b,s,h,n,with_s0", [
    (1, 300, 40, 64, False), (1, 128, 40, 64, True), (2, 40, 4, 16, True),
    (1, 1, 2, 32, False), (1, 77, 8, 64, True), (3, 33, 4, 32, False),
    (8, 200, 40, 64, False), (8, 37, 40, 64, True)])
def test_rwkv6_wkv_kernel_matches_plain(card, dtype, b, s, h, n, with_s0,
                                        decay):
    """rwkv6-3b's widths, lengths that are no multiple of the kernel's
    32-token chunk, and both decay ranges."""
    _wkv_check(_wkv_inputs(card, dtype, b, s, h, n, with_s0,
                           DECAYS[decay]), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("b,s,h,n", [(1, 70, 8, 64), (2, 37, 4, 16)])
def test_rwkv6_wkv_kernel_unaligned_views(card, dtype, b, s, h, n):
    """Views whose rows are not 16-byte aligned take the kernel's
    element-by-element staging; same results as the plain version."""
    args = _wkv_inputs(card, dtype, b, s, h, n, True, DECAYS["full"], pad=1)
    assert args[0].data_ptr() % 16 and not args[0].is_contiguous()
    _wkv_check(args, dtype)


@pytest.mark.parametrize("arch", ["smollm-135m", "deepseek-moe-16b",
                                  "recurrentgemma-2b", "rwkv6-3b"])
def test_executor_on_card_matches_host(card, arch):
    """SMOKE config (fp32) served on the card through the kernels gives
    the host's tokens on the same weights and requests, through the
    executor ``make_executor`` picks (batched paged for dense and MoE,
    per-slot for the recurrent families).  On the card the decode step and
    each prompt length's prefill are captured graphs: the counters see
    their warm-up and capture calls (``decode_graph_stats()["calls"]``,
    ``prefill_graph_stats()["calls"]``), not their replays, and every
    prefill is a replay."""
    from repro_torch.configs import get_smoke
    from repro_torch.models.init import init_params
    from repro_torch.serve.batched_executor import make_executor
    from repro_torch.serve.engine import (NO_SLO, ContinuousServeEngine,
                                          ServeRequest)

    cfg = get_smoke(arch)
    n_moe = (cfg.num_layers - cfg.first_k_dense) if cfg.num_experts else 0
    n_attn = sum(cfg.is_attention_layer(i) for i in range(cfg.num_layers))
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = {}
    mods = (fmod, pmod, gmod, smod, wmod)

    def to(tree, dev):
        if isinstance(tree, dict):
            return {k: to(v, dev) for k, v in tree.items()}
        return tree.to(dev)

    for dev in ("cpu", "cuda"):
        # counted from before the executor: on the card it captures its
        # batched decode step as it is built
        n0 = [m.LAUNCHES for m in mods]
        ex, kv = make_executor(cfg, 160, 4, device=dev,
                               params=to(params, dev))
        rng = np.random.default_rng(1)
        reqs = [ServeRequest(rid=i, prompt_len=n, max_new=m,
                             prompt=rng.integers(0, cfg.vocab_size, n)
                             .astype(np.int32))
                for i, (n, m) in enumerate([(5, 9), (130, 20), (60, 4),
                                            (17, 12), (99, 30), (3, 2)])]
        ContinuousServeEngine(4, ex, slo=NO_SLO, kv_cache=kv).run(reqs)
        got = [m.LAUNCHES - n for m, n in zip(mods, n0)]
        p = ex.prefill_graph_stats()
        pre, dec = p["calls"], ex.decode_graph_stats()["calls"]
        assert p["replays"] == (ex.prefills if dev == "cuda" else 0)
        if dev == "cpu":
            assert got == [0] * 5
        elif cfg.family == "hybrid":
            assert got == [n_attn * pre, 0, 0,
                           (cfg.num_layers - n_attn) * pre, 0]
        elif cfg.family == "ssm":
            assert got == [0, 0, 0, 0, cfg.num_layers * pre]
        else:
            assert got == [cfg.num_layers * pre, cfg.num_layers * dec,
                           3 * n_moe * (pre + dec), 0, 0]
        toks[dev] = [r.out_tokens for r in reqs]
    assert toks["cuda"] == toks["cpu"]
