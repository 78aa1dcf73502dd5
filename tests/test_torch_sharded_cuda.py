"""Card-only: the sharded train step (``launch.strategy.
ShardedTrainStep``) through NCCL at world size 1, as ``chip_smoke.py``'s
``distributed`` phase runs it, at SMOKE widths with head_dim 64 (the
flash backward's): smollm-135m and deepseek-moe-16b with
``moe_impl="ep"`` (``moe_ep``'s all-to-alls through NCCL), bf16
compute.  Both steps are captured CUDA graphs; after 3 steps on the
same batches from the same state the sharded step's params, m, v, step
and metrics equal ``TrainStep``'s bit for bit, its collectives include
the EP step's all-to-alls, and the flash (and for the MoE the grouped
matmul) kernels were launched.

The sharded serving steps (``ShardedPrefillStep``,
``ShardedDecodeStep``), as phase 13's ``distributed_serve`` runs them:
smollm-135m and deepseek-moe-16b (``moe_impl="ep"``) at the same SMOKE
widths, the caller's parameters shared by both captured steps, a
(4, 128) prompt into a 160-slot cache and 4 greedy steps: every logit,
token and cache leaf equal to the unsharded ``prefill_fn`` and
``decode_step_inplace`` (one captured graph each) bit for bit, the flash
and (for the MoE) grouped-matmul kernels launched in the sharded steps.

The recurrent families (recurrentgemma-2b with head_dim 64, rwkv6-3b,
SMOKE widths, bf16 compute) take the same three steps against the
unsharded ones bit for bit, the RG-LRU scan and its reverse, or the WKV
and its reverse, launched inside the sharded steps (on each rank's
block through ``run_local``).  The scans on the halves a 2-rank model
axis would hold (the RG-LRU's channels, the WKV's heads), stitched
back, equal the whole call: bit for bit, but the WKV reverse where
``bwd_segments`` cuts the half otherwise, held within the smoke's
``WKV_BWD_RTOL`` of each gradient's largest element.

The enc-dec and vlm families (whisper-medium and llava-next-mistral-7b,
head_dim 64, SMOKE widths, bf16 compute; each batch with its frames or
patches drawn from a normal, rows that differ) take the same three
steps against the unsharded ones bit for bit, flash and its backward
launched inside the sharded steps; whisper's decode runs 68 steps from a
128-token prompt, past the end of its 192-slot ring (the prompt + 64)
in a 224-slot buffer.

Every test carries the ``cuda`` marker and skips without a card.  On a
machine with one:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_sharded_cuda.py
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.kernels.flash_attention import \
    flash_attention as fa  # noqa: E402
from repro_torch.kernels.moe_gmm import moe_gmm as mg  # noqa: E402
from repro_torch.kernels.rglru_scan import rglru_scan as rs  # noqa: E402
from repro_torch.kernels.rwkv6_wkv import rwkv6_wkv as wk  # noqa: E402
from repro_torch.launch.strategy import (ShardedTrainStep,  # noqa: E402
                                         TrainStep, init_train_state)
from repro_torch.optim import AdamWConfig  # noqa: E402
from repro_torch.tree import flatten, tree_map  # noqa: E402

pytestmark = pytest.mark.cuda

B, S = 4, 128
OPT = AdamWConfig(lr=1e-3)
CASES = {"smollm": ("smollm-135m", {}),
         "deepseek_ep": ("deepseek-moe-16b", {"moe_impl": "ep"}),
         "hybrid": ("recurrentgemma-2b", {}),
         "ssm": ("rwkv6-3b", {}),
         "encdec": ("whisper-medium", {}),
         "vlm": ("llava-next-mistral-7b", {})}
# the kernel modules each case's steps launch (forward counters)
KERNELS = {"smollm": (fa,), "deepseek_ep": (fa, mg), "hybrid": (fa, rs),
           "ssm": (wk,), "encdec": (fa,), "vlm": (fa,)}
# greedy steps of the serving test: whisper's past its ring's end
DECODE = {"encdec": 68}
MODULES = (fa, mg, rs, wk)
# the smoke's bound of the reverse WKV against another summation order
WKV_BWD_RTOL = 1e-4


def _batch(cfg, g):
    """A host batch of B x S positions: tokens (the vlm's S - num_patches
    of them), and the enc-dec family's frames or the vlm's patches drawn
    from a normal in bf16."""
    n_tok = S - cfg.num_patches if cfg.family == "vlm" else S
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, n_tok),
                                     generator=g, dtype=torch.int32)}
    stub = {"encdec": ("frames", cfg.encoder_positions),
            "vlm": ("patches", cfg.num_patches)}.get(cfg.family)
    if stub:
        batch[stub[0]] = torch.randn((B, stub[1], cfg.d_model),
                                     generator=g).to(torch.bfloat16)
    return batch


def _reset():
    for mod in MODULES:
        mod.LAUNCHES = 0
        mod.LAUNCHES_BWD = 0


def _launched(counter="LAUNCHES"):
    return {mod for mod in MODULES if getattr(mod, counter)}


@pytest.fixture(scope="module")
def mesh(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: NCCL and CUDA graphs have no CPU "
                    "mode")
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_distributed, make_dev_mesh

    store = tmp_path_factory.mktemp("nccl") / "store"
    init_distributed(init_method=f"file://{store}")
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield make_dev_mesh(1, 1)
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = saved
    dist.destroy_process_group()


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_step_equals_train_step(mesh, case):
    arch, knobs = CASES[case]
    cfg = dataclasses.replace(get_smoke(arch), head_dim=64,
                              compute_dtype=torch.bfloat16, **knobs)
    s0 = init_train_state(cfg, torch.Generator("cuda").manual_seed(0),
                          "cuda")
    g = torch.Generator().manual_seed(1)
    batches = [_batch(cfg, g) for _ in range(3)]
    ref = TrainStep(cfg, OPT, s0, B, S, "graph")
    _reset()
    got = ShardedTrainStep(cfg, OPT, mesh, s0, B, S, "graph")
    # the forward and reverse kernels, inside the sharded step
    assert _launched() == set(KERNELS[case])
    assert _launched("LAUNCHES_BWD") == set(KERNELS[case])
    for bt in batches:
        a = {k: v.clone() for k, v in ref(bt).items()}
        b = {k: v.clone() for k, v in got(bt).items()}
        assert a.keys() == b.keys()
        assert all(torch.equal(a[k], b[k]) for k in a)
    want = flatten(ref.state)[0]
    have = flatten(tree_map(lambda t: t.to_local(), got.state))[0]
    assert len(want) == len(have)
    assert all(torch.equal(x, y) for x, y in zip(want, have))
    assert got.graph.replays == 3
    kinds = got.collectives.stats().count_by_kind
    if cfg.num_experts:
        assert kinds.get("all-to-all", 0) > 0


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_serving_steps_equal_unsharded(mesh, case):
    from repro_torch.launch.strategy import (ShardedDecodeStep,
                                             ShardedPrefillStep)
    from repro_torch.models import model
    from repro_torch.models.init import init_params
    from repro_torch.serve.decode_graph import DecodeGraph
    from repro_torch.step_graph import StepGraph
    from repro_torch.tree import copy_tree_

    arch, knobs = CASES[case]
    cfg = dataclasses.replace(get_smoke(arch), head_dim=64,
                              compute_dtype=torch.bfloat16, **knobs)
    dev = torch.device("cuda")
    max_len = S + 32
    params = init_params(cfg, torch.Generator(dev).manual_seed(0), dev)
    prompt = _batch(cfg, torch.Generator().manual_seed(1))
    steps = DECODE.get(case, 4)
    pfn, dfn = model.prefill_fn(cfg, max_len), model.decode_inplace_fn(cfg)
    bufs = {"batch": {k: v.to(dev) for k, v in prompt.items()},
            "cache": model.init_cache(cfg, B, max_len, dev),
            "logits": torch.zeros((B, cfg.vocab_size), device=dev),
            "token": torch.zeros((B,), dtype=torch.int32, device=dev)}

    def prefill(b):
        logits, cache = pfn(params, b["batch"])
        b["logits"].copy_(logits)
        copy_tree_(b["cache"], cache, "cache")

    def decode(b):
        b["logits"].copy_(dfn(params, b["token"], b["cache"]))

    pg = StepGraph(prefill, bufs, dev, "graph")
    dg = DecodeGraph(decode, bufs, dev, "graph")
    _reset()
    pre = ShardedPrefillStep(cfg, mesh, params, B, S, max_len, "graph")
    dec = ShardedDecodeStep(cfg, mesh, params, B, max_len, "graph")
    assert _launched() == set(KERNELS[case])
    # the unsharded graphs' warm-ups advanced their cache: run the prefill
    # again, which rewrites it
    pg()
    got = pre(prompt)
    assert torch.equal(got, bufs["logits"])
    dec.load_cache(pre.cache)
    for _ in range(steps):
        tok = bufs["logits"].argmax(-1).to(torch.int32)
        assert torch.equal(tok, got.argmax(-1).to(torch.int32))
        bufs["token"].copy_(tok)
        dg()
        got = dec(tok)
        assert torch.equal(got, bufs["logits"])
    want = flatten(bufs["cache"])[0]
    have = flatten(tree_map(lambda t: t.to_local(), dec.cache))[0]
    assert len(want) == len(have)
    assert all(torch.equal(x, y) for x, y in zip(want, have))
    assert (pre.graph.replays, dec.graph.replays) == (1, steps)
    if cfg.family == "encdec":
        # every row wrote past its ring's end
        assert bool((bufs["cache"]["pos"] > bufs["cache"]["ring"]).all())


def _stitch(parts, i, dim):
    return torch.cat([p[i] for p in parts], dim)


def test_split_rglru_scan_equals_the_whole(mesh):
    g = torch.Generator("cuda").manual_seed(2)
    a = 0.85 + 0.149 * torch.rand((2, 300, 256), generator=g, device="cuda")
    x = 0.1 * torch.randn((2, 300, 256), generator=g, device="cuda")
    dh = torch.randn((2, 300, 256), generator=g, device="cuda")
    h = rs.rglru_scan(a, x)
    whole = (h, *rs.rglru_scan_bwd(a, h, dh)[:2])
    parts = []
    for ah, xh, dhh in zip(*(t.chunk(2, 2) for t in (a, x, dh))):
        ah, xh, dhh = ah.contiguous(), xh.contiguous(), dhh.contiguous()
        hh = rs.rglru_scan(ah, xh)
        parts.append((hh, *rs.rglru_scan_bwd(ah, hh, dhh)[:2]))
    for i in range(3):
        assert torch.equal(_stitch(parts, i, 2), whole[i]), i


def test_split_wkv_equals_the_whole(mesh):
    g = torch.Generator("cuda").manual_seed(3)
    b, s, h, n = 2, 300, 8, 64
    r, k, v, do = (0.5 * torch.randn((b, s, h, n), generator=g,
                                     device="cuda") for _ in range(4))
    logw = -torch.exp(torch.empty((b, s, h, n), device="cuda")
                      .uniform_(-6.0, -1.0, generator=g))
    u = 0.1 * torch.randn((h, n), generator=g, device="cuda")
    fwd = wk.rwkv6_wkv(r, k, v, logw, u, states=True)
    bwd = wk.rwkv6_wkv_bwd(r, k, v, logw, u, do, fwd[2])[:5]
    parts_f, parts_b = [], []
    for j in range(2):
        heads = slice(j * h // 2, (j + 1) * h // 2)
        rh, kh, vh, lh, doh = (t[:, :, heads].contiguous()
                               for t in (r, k, v, logw, do))
        uh = u[heads].contiguous()
        f = wk.rwkv6_wkv(rh, kh, vh, lh, uh, states=True)
        parts_f.append(f)
        parts_b.append(wk.rwkv6_wkv_bwd(rh, kh, vh, lh, uh, doh, f[2])[:5])
    for i, d in enumerate((2, 1, 1)):        # o, state, chunk states
        assert torch.equal(_stitch(parts_f, i, d), fwd[i]), i
    same_cut = (wk.bwd_segments(b, s, h, n)[0]
                == wk.bwd_segments(b, s, h // 2, n)[0])
    for i, d in enumerate((2, 2, 2, 2, 0)):  # dr, dk, dv, dlogw, du
        got, want = _stitch(parts_b, i, d), bwd[i]
        if same_cut:
            assert torch.equal(got, want), i
        lim = WKV_BWD_RTOL * (want.abs().max() + want.abs())
        assert bool(((got - want).abs() <= lim).all()), i
