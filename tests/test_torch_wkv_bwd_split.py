"""The CUDA reverse WKV's segment split, on the CPU (the kernel runs only
on the card: ``test_torch_wkv_bwd_cuda.py``, ``chip_smoke.py``).  The
kernel cuts the sequence into segments of whole 32-token chunks: a carry
launch computes each later segment's part of the state gradient G from
zero and its decay product, the main launch joins them in a fixed order
into each segment's incoming G and runs the reverse over the segment
alone.  ``ref.rwkv6_wkv_bwd_split_ref`` is that arithmetic in plain
PyTorch.  Checked here, on the same numpy inputs as the reference:

* the split model against the serial plain reverse ``rwkv6_wkv_bwd_ref``
  and against ``jax.vjp`` of the reference model's ``wkv_scan``, with one
  segment, two, and four whose last is ragged (s 100 = 32 + 32 + 32 + 4),
  s not a multiple of 32, batch 2, with and without s0 / ds, at the usual
  decays;
* at the model's full decay range (logw = -exp(d), d in [-20, 10]) the
  fp32 split against the fp64 serial reverse (the reference's chunked
  form is no yardstick there: ``test_torch_wkv_bwd.py`` says why);
* in fp64 the split equals the serial reverse to rounding (1e-12 of the
  largest element): the segments change only the order of the sums;
* ``bwd_segments`` depends on the shape alone, cuts on chunk boundaries
  into about as many parts as bring the main launch to
  ``SEG_TARGET_BLOCKS`` blocks, brings rwkv6-3b's training shape to at
  least four blocks for each of the H100's 132 SMs, and the kernel's
  ``segments`` cuts with the same expression and target (read from the
  source).

Tolerance for fp32: 1e-5 of each gradient's largest element plus 1e-5
relative, as in ``test_torch_wkv_bwd.py`` (both sides sum the same fp32
products in another order; a wrong term moves an element by the order
of the largest).
"""
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import rwkv as jrw  # noqa: E402
from repro_torch.kernels.rwkv6_wkv import rwkv6_wkv as kmod  # noqa: E402
from repro_torch.kernels.rwkv6_wkv.ref import (  # noqa: E402
    rwkv6_wkv_bwd_ref, rwkv6_wkv_bwd_split_ref)

RTOL = 1e-5
NAMES = ("dr", "dk", "dv", "dlogw", "du", "ds0")
SOURCE = Path(kmod.__file__).resolve().parents[1] / "csrc" / "rwkv6_wkv.cu"


def _assert_close(got, want, name, rtol=RTOL):
    want = np.asarray(want, dtype=np.float64)
    np.testing.assert_allclose(np.asarray(got, dtype=np.float64), want,
                               rtol=rtol, atol=rtol * np.abs(want).max(),
                               err_msg=name)


def _inputs(b, s, h, n, seed, decay=None):
    rng = np.random.default_rng(seed)
    r, k, v = (0.5 * rng.standard_normal((b, s, h, n)) for _ in range(3))
    logw = (-np.exp(0.5 * rng.standard_normal((b, s, h, n))) if decay is None
            else -np.exp(rng.uniform(*decay, (b, s, h, n))))
    u = 0.5 * rng.standard_normal((h, n))
    do = rng.standard_normal((b, s, h, n))
    s0, ds = (rng.standard_normal((b, h, n, n)) for _ in range(2))
    return [a.astype(np.float32) for a in (r, k, v, logw, u, do, s0, ds)]


def _torch(args, with_state, dtype=torch.float32):
    r, k, v, logw, u, do, s0, ds = (torch.from_numpy(a).to(dtype)
                                    for a in args)
    return (r, k, v, logw, u, do) + ((s0, ds) if with_state else (None, None))


def _jax_scan_vjp(r, k, v, logw, u, do, s0, ds):
    args = [jnp.asarray(a) for a in (r, k, v, logw, u, s0)]
    _, vjp = jax.vjp(lambda r, k, v, lw, u, s0: jrw.wkv_scan(
        r, k, v, jnp.exp(lw), u, s0), *args)
    return vjp((jnp.asarray(do), jnp.asarray(ds)))


# (b, s, segment): one segment, two, four with a ragged last (32 + 32 +
# 32 + 4), batch 2 over 64 + 13
SPLITS = [(1, 64, 64), (2, 64, 32), (1, 100, 32), (2, 77, 64)]


@pytest.mark.parametrize("with_state", [False, True], ids=["zeros", "s0"])
@pytest.mark.parametrize("b,s,segment", SPLITS)
def test_split_matches_serial_reverse_and_jax_vjp(b, s, segment, with_state):
    args = _inputs(b, s, 2, 16, seed=s + segment + with_state)
    if not with_state:
        args[6], args[7] = np.zeros_like(args[6]), np.zeros_like(args[7])
    got = rwkv6_wkv_bwd_split_ref(*_torch(args, with_state),
                                  segment=segment)
    serial = rwkv6_wkv_bwd_ref(*_torch(args, with_state))
    jgrads = _jax_scan_vjp(*args)
    for name, g, w, j in zip(NAMES, got, serial, jgrads):
        if not with_state and name == "ds0":
            assert g is None and w is None
            continue
        assert g.dtype == torch.float32 and g.shape == w.shape, name
        _assert_close(g.numpy(), w.numpy(), name)
        _assert_close(g.numpy(), j, name)


@pytest.mark.parametrize("b,s,segment", [(2, 100, 32), (1, 130, 64)])
def test_split_full_decay_range_matches_fp64(b, s, segment):
    """w from 1 - 2e-9 to 0: decay products underflow to zero inside a
    segment; the fp32 split stays within the tolerance of the fp64
    serial reverse."""
    args = _inputs(b, s, 2, 16, seed=300 + s, decay=(-20.0, 10.0))
    got = rwkv6_wkv_bwd_split_ref(*_torch(args, True), segment=segment)
    want = rwkv6_wkv_bwd_ref(*_torch(args, True, torch.float64))
    for name, g, w in zip(NAMES, got, want):
        assert g.dtype == torch.float32 and w.dtype == torch.float64
        _assert_close(g.numpy(), w.numpy(), name)


@pytest.mark.parametrize("decay", [None, (-20.0, 10.0)],
                         ids=["usual", "full"])
@pytest.mark.parametrize("segment", [32, 64, 96])
def test_split_in_fp64_is_the_serial_reverse_reordered(segment, decay):
    args = _inputs(2, 100, 2, 8, seed=segment, decay=decay)
    got = rwkv6_wkv_bwd_split_ref(*_torch(args, True, torch.float64),
                                  segment=segment)
    want = rwkv6_wkv_bwd_ref(*_torch(args, True, torch.float64))
    for name, g, w in zip(NAMES, got, want):
        assert g.dtype == torch.float64, name
        _assert_close(g.numpy(), w.numpy(), name, rtol=1e-12)


# (b, s, h, n): rwkv6-3b's training shape and its batch-2 case, the card
# tests' shapes, a prefill, SMOKE widths
SHAPES = [(1, 4096, 40, 64), (2, 2048, 40, 64), (1, 4133, 8, 64),
          (2, 1000, 4, 32), (1, 300, 40, 64), (8, 200, 40, 64),
          (1, 37, 3, 16), (2, 33, 40, 64), (1, 1, 2, 32)]


def test_bwd_segments_depends_on_the_shape_alone(monkeypatch):
    want = [kmod.bwd_segments(*s) for s in SHAPES]

    def refuse(*a, **kw):
        raise AssertionError("bwd_segments asked the card")

    for name in ("get_device_properties", "device_count",
                 "get_device_name", "is_available"):
        monkeypatch.setattr(torch.cuda, name, refuse)
    assert [kmod.bwd_segments(*s) for s in SHAPES] == want


@pytest.mark.parametrize("b,s,h,n", SHAPES)
def test_bwd_segments_cut_whole_chunks(b, s, h, n):
    segs, per = kmod.bwd_segments(b, s, h, n)
    chunks = kmod.n_state_chunks(s)
    assert 1 <= segs <= chunks and per >= 1
    assert (segs - 1) * per < chunks <= segs * per   # the last is not empty
    per_segment = b * h * kmod.bwd_row_blocks(n)
    want = min(chunks, -(-kmod.SEG_TARGET_BLOCKS // per_segment))
    # at most the parts that reach the target, and at least half of them
    # (each part rounded up to whole chunks)
    assert want / 2 <= segs <= want
    # the shortest segments that give no more parts than that
    assert -(-chunks // per) <= want and (per == 1
                                          or -(-chunks // (per - 1)) > want)


def test_training_shape_fills_the_card():
    """rwkv6-3b's training shape: four blocks or more for each of the
    H100's 132 SMs in the main launch (two resident on each)."""
    segs, per = kmod.bwd_segments(1, 4096, 40, 64)
    assert segs * 40 * 2 >= 4 * 132
    assert (segs, per) == (13, 10)


def test_kernel_cuts_the_segments_as_bwd_segments_does():
    text = SOURCE.read_text()
    body = re.search(r"Segments segments\([^)]*\)\s*\{(.*?)\n\}", text, re.S)
    assert body is not None
    assert " ".join(body.group(1).split()) == (
        "const int chunks = (seq + kT - 1) / kT; "
        "const int blocks = std::max(1, b * h * (n / std::min(n, 32))); "
        "const int want = std::max( 1, std::min(chunks, "
        "(kSegTargetBlocks + blocks - 1) / blocks)); "
        "const int per = (chunks + want - 1) / want; "
        "return {(chunks + per - 1) / per, per};")
    target = re.search(r"constexpr int kSegTargetBlocks = (\d+);", text)
    assert int(target.group(1)) == kmod.SEG_TARGET_BLOCKS
    assert re.search(r"constexpr int kT = (\d+);", text).group(1) == str(
        kmod.STATE_CHUNK)
    assert "static constexpr int RB = N < 32 ? N : 32;" in text
    assert kmod.ROW_BLOCK == 32


@pytest.mark.parametrize("b,s,h,n", SHAPES)
def test_workspace_holds_the_carries_and_partials(b, s, h, n):
    """The carries of segments 1 .. P-1 (L and D) and du per segment and
    batch row; nothing when a head's row blocks sum dv between them."""
    segs, _ = kmod.bwd_segments(b, s, h, n)
    bhn = b * h * n
    assert kmod.bwd_workspace_elems(b, s, h, n) == (
        (segs - 1) * (bhn * n + bhn) + segs * bhn)
