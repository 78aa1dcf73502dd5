"""The port's cost reference (``repro_torch.core.costref``) on the CPU:
its counts of the plain step on ``meta`` tensors against the
reference's XLA counts, and its extrapolation against direct counts.

* The fit at a layer count, batch and seq beyond its points equals a
  direct count at the target, flops and bytes, to 1e-9 relative: for
  the dense smollm-135m (SMOKE widths, 8 layers over the points 2 / 4 /
  6, batch 5 over 2 / 3, seq 10,240 over 2,048 / 4,096 / 6,144) and
  the hybrid recurrentgemma-2b (12 layers over 3 / 6 / 9, batch 5, seq
  20 over 4 / 8 / 12, across its 16-position window).
* The counted flops of each SMOKE family's train step and prefill at 2 x
  64 lie within 0.85-1.05 of the reference's ``_compile_cost`` flops:
  ``FlopCounterMode`` counts the matmul-class ops only, XLA the
  elementwise ones too.  Whisper's train step is the exception the same
  rule explains: XLA counts AdamW's ~19 flops a parameter, and whisper's
  SMOKE parameters are 92% its 32,768 x 64 ``pos_dec`` table, so the raw
  ratio is 0.737; against the reference's step less its own AdamW count
  (XLA's cost of ``adamw_apply`` alone) it is 0.945, in the band.
* The points are the reference's (``_layer_points``, ``_batch_points``,
  ``_seq_points``) but the batches (2 / 3 for 1 / 2) and the scan
  families' seqs; the byte counter counts
  each non-view op's inputs and outputs, and a kernel's plain version
  as the kernel, its tensors in and out once each (exact byte counts);
  the cache reads back, and its key moves with the port's source.
"""
import importlib
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as jconfig  # noqa: E402
from repro.configs import get_smoke as jsmoke  # noqa: E402
from repro.core import costref as jcost  # noqa: E402
from repro.launch.strategy import abstract_train_state  # noqa: E402
from repro.models import config as jmc  # noqa: E402
from repro.optim import AdamWConfig, adamw_apply  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config, get_smoke  # noqa: E402
from repro_torch.core import costref  # noqa: E402
from repro_torch.models.config import SHAPES, ShapeConfig  # noqa: E402

FAMILIES = ["smollm-135m", "deepseek-moe-16b", "recurrentgemma-2b",
            "rwkv6-3b", "whisper-medium", "llava-next-mistral-7b"]
BAND = (0.85, 1.05)
FIT_RTOL = 1e-9


@pytest.fixture(autouse=True)
def _cache_dir(tmp_path, monkeypatch):
    monkeypatch.setattr(costref, "CACHE_DIR", tmp_path / "costref")


def _rel(a, b):
    return abs(a - b) / abs(b)


def test_fit_equals_direct_count_attention():
    cfg = dataclasses.replace(get_smoke("smollm-135m"), num_layers=8)
    shape = ShapeConfig("t", "train", 10_240, 5)
    assert costref._layer_points(cfg) == [2, 4, 6]
    assert costref._seq_points(cfg, shape) == [2048, 4096, 6144]
    assert costref._batch_points(cfg, shape) == [2, 3]
    fit = costref.cost_reference(cfg, shape)
    flops, nbytes = costref.count_cost(cfg, shape)
    assert _rel(fit["flops"], flops) < FIT_RTOL
    assert _rel(fit["bytes"], nbytes) < FIT_RTOL
    assert len(fit["ref_points"]) == 18


def test_fit_equals_direct_count_scan(monkeypatch):
    # points below the window, the target above it: the plain attention
    # scores every pair and masks after, so the count is one quadratic
    monkeypatch.setattr(costref, "_SCAN_SEQ_POINTS", (4, 8, 12))
    cfg = dataclasses.replace(get_smoke("recurrentgemma-2b"), num_layers=12)
    shape = ShapeConfig("t", "train", 20, 5)
    assert cfg.attention_window == 16
    assert costref._layer_points(cfg) == [3, 6, 9]
    assert costref._seq_points(cfg, shape) == [4, 8, 12]
    fit = costref.cost_reference(cfg, shape)
    flops, nbytes = costref.count_cost(cfg, shape)
    assert flops > 0
    assert _rel(fit["flops"], flops) < FIT_RTOL
    assert _rel(fit["bytes"], nbytes) < FIT_RTOL


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_points_match_reference(arch):
    tcfg, jcfg = get_config(arch), jconfig(arch)
    assert costref._layer_points(tcfg) == jcost._layer_points(jcfg)
    for ts, js in zip(SHAPES, jmc.SHAPES):
        # the batch points: the reference's 1 / 2 moved to 2 / 3
        assert costref._batch_points(tcfg, ts) == [
            b + (len(jcost._batch_points(js)) - 1)
            for b in jcost._batch_points(js)]
        if tcfg.family in costref._SCAN_FAMILIES and ts.kind != "decode":
            continue
        assert costref._seq_points(tcfg, ts) == jcost._seq_points(jcfg, js)


def test_scan_seq_points():
    hyb, ssm = get_config("recurrentgemma-2b"), get_config("rwkv6-3b")
    w = hyb.attention_window
    pts = list(costref._SCAN_SEQ_POINTS)
    assert costref._seq_points(hyb, ShapeConfig("t", "train", 4096, 1)) == pts
    assert costref._seq_points(ssm, ShapeConfig("t", "train", 4096, 1)) == pts
    # a hybrid prefill trims its cache to the window: points above it
    assert costref._seq_points(hyb, ShapeConfig("p", "prefill", 32768, 1)) \
        == [w + p for p in pts]
    assert costref._seq_points(ssm, ShapeConfig("p", "prefill", 40, 1)) \
        == [40]
    assert costref._seq_points(hyb, ShapeConfig("d", "decode", 9000, 1)) \
        == [9000]
    # microbatches split the batch: whole multiples of them
    mb = dataclasses.replace(hyb, microbatches=4)
    assert costref._batch_points(mb, ShapeConfig("t", "train", 64, 256)) \
        == [8, 12]
    assert costref._batch_points(mb, ShapeConfig("t", "train", 64, 8)) \
        == [8]
    assert costref._batch_points(hyb, ShapeConfig("t", "train", 64, 2)) \
        == [2]


def test_byte_counter_counts_inputs_and_outputs_of_non_views():
    a = torch.empty((4, 8), device="meta")
    b = torch.empty((8, 16), device="meta")
    with costref.ByteCounter() as bc:
        c = a @ b                   # reads 32 + 128, writes 64 floats
        c.view(64)                                 # a view: nothing
        torch.empty((1000,), device="meta")        # an allocation: nothing
    assert bc.bytes == 4 * (32 + 128 + 64)


_PLAIN = [(m, n) for m, names in costref._KERNEL_PLAIN.items()
          for n in names]


@pytest.mark.parametrize("mod_name,name", _PLAIN)
def test_kernel_bytes_wraps_each_plain_version(mod_name, name):
    mod = importlib.import_module(mod_name)
    plain = getattr(mod, name)
    with costref.kernel_bytes(costref.ByteCounter()):
        assert getattr(mod, name).__wrapped__ is plain
    assert getattr(mod, name) is plain


def _nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def test_kernel_bytes_counts_flash_forward_as_its_kernel():
    from repro_torch.kernels.flash_attention.ops import flash_attention_bshd
    q = torch.empty((2, 64, 4, 16), device="meta")
    kv = torch.empty((2, 64, 2, 16), device="meta")
    with costref.ByteCounter() as bc, costref.kernel_bytes(bc):
        o = flash_attention_bshd(q, kv, kv, causal=True, impl="ref")
    # q, k, v read and o written; no (query, key) score
    assert bc.bytes == _nbytes(q, kv, kv, o)
    with costref.ByteCounter() as plain:
        flash_attention_bshd(q, kv, kv, causal=True, impl="ref")
    assert plain.bytes > bc.bytes + 4 * 2 * 4 * 64 * 64


def test_kernel_bytes_counts_scan_forward_and_backward_as_kernels():
    from repro_torch.kernels.rglru_scan.ops import rglru_scan
    a = torch.empty((2, 32, 8), device="meta", requires_grad=True)
    b = torch.empty((2, 32, 8), device="meta", requires_grad=True)
    dh = torch.empty((2, 32, 8), device="meta")
    with costref.ByteCounter() as bc, costref.kernel_bytes(bc):
        h = rglru_scan(a, b, impl="ref")
        fwd = bc.bytes
        da, db = torch.autograd.grad(h, (a, b), dh)
    assert fwd == _nbytes(a, b, h)
    # the reverse scan reads a, h and dh and writes da and db
    assert bc.bytes - fwd == _nbytes(a, h, dh, da, db)


def test_cache_key_moves_with_the_source(monkeypatch):
    cfg = get_smoke("smollm-135m")
    shape = ShapeConfig("t", "prefill", 16, 1)
    key = costref._cache_key(cfg, shape)
    monkeypatch.setattr(costref, "_source_hash", lambda: "changed")
    assert costref._cache_key(cfg, shape) != key


def test_cost_reference_reads_its_cache(monkeypatch):
    cfg = get_smoke("smollm-135m")
    shape = ShapeConfig("t", "prefill", 16, 1)
    first = costref.cost_reference(cfg, shape)
    monkeypatch.setattr(costref, "count_cost", None)    # no count again
    assert costref.cost_reference(cfg, shape) == first
    assert first["flops"] > 0 and first["count_s"] >= 0


def _reference_adamw_flops(jcfg):
    st = abstract_train_state(jcfg)
    fn = jax.jit(lambda g, o, p: adamw_apply(g, o, p, AdamWConfig()))
    cost = fn.lower(st["params"], st["opt"], st["params"]).compile() \
        .cost_analysis()
    return float(cost["flops"])


@pytest.mark.parametrize("kind", ["train", "prefill"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_counted_flops_near_reference(arch, kind):
    tcfg, jcfg = get_smoke(arch), jsmoke(arch)
    flops, _ = costref.count_cost(tcfg, ShapeConfig("t", kind, 64, 2))
    ref, _ = jcost._compile_cost(jcost._unrolled(jcfg),
                                 jmc.ShapeConfig("t", kind, 64, 2))
    if arch == "whisper-medium" and kind == "train":
        adamw = _reference_adamw_flops(jcost._unrolled(jcfg))
        # ~19 flops a parameter; 2,097,152 of the 2,271,872 are pos_dec
        assert adamw >= 19 * 32_768 * tcfg.d_model
        assert flops / ref < BAND[0]
        ref -= adamw
    assert BAND[0] <= flops / ref <= BAND[1], flops / ref
