"""Port params: the spec tree matches the reference's abstract params
(keys, shapes, dtypes) at SMOKE and full size, the configs carry the
reference's numbers, init follows the reference's rules, and the numpy
weight bridge round-trips exactly."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jcfgs  # noqa: E402
from repro.models import init as jinit  # noqa: E402
from repro_torch import configs as tcfgs  # noqa: E402
from repro_torch.models import init as tinit  # noqa: E402

ARCHS = ["smollm-135m", "qwen2.5-14b", "granite-3-8b", "qwen2-72b",
         "deepseek-moe-16b", "mixtral-8x7b", "recurrentgemma-2b", "rwkv6-3b",
         "llava-next-mistral-7b", "whisper-medium"]


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flat(v, name))
        else:
            out[name] = v
    return out


def _cfgs(arch, size):
    if size == "smoke":
        return jcfgs.get_smoke(arch), tcfgs.get_smoke(arch)
    return jcfgs.get_config(arch), tcfgs.get_config(arch)


@pytest.mark.parametrize("size", ["smoke", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_spec_tree_matches_reference_abstract_params(arch, size):
    """Full size is compared abstractly: JAX ShapeDtypeStructs against
    torch meta tensors, nothing allocated."""
    jcfg, tcfg = _cfgs(arch, size)
    ref = {k: (tuple(s.shape), np.dtype(s.dtype).name)
           for k, s in _flat(jinit.abstract_params(jcfg)).items()}
    got = {k: (tuple(t.shape), str(t.dtype).replace("torch.", ""))
           for k, t in _flat(tinit.abstract_params(tcfg)).items()}
    assert got == ref
    assert tcfg.num_params() == jcfg.num_params()


@pytest.mark.parametrize("size", ["smoke", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_fields_match_reference(arch, size):
    jcfg, tcfg = _cfgs(arch, size)
    j = dataclasses.asdict(jcfg)
    t = dataclasses.asdict(tcfg)
    for key in ("param_dtype", "compute_dtype"):
        assert np.dtype(j.pop(key)).name == str(t.pop(key)).split(".")[-1]
    assert t == j


@pytest.mark.parametrize("arch,n", [("granite-3-8b", 8_372_187_136),
                                    ("qwen2-72b", 72_706_203_648)])
def test_dense_configs_published_sizes(arch, n):
    """The two dense configs of the static engine's slice at their
    published widths: the reference's parameter counts, exactly."""
    assert tcfgs.get_config(arch).num_params() == n
    assert jcfgs.get_config(arch).num_params() == n


@pytest.mark.parametrize("arch,n", [("whisper-medium", 791_778_304),
                                    ("llava-next-mistral-7b", 7_241_732_096)])
def test_encdec_and_vlm_configs_published_sizes(arch, n):
    """The enc-dec and VLM slice's configs at their published widths:
    the reference's parameter counts, exactly."""
    assert tcfgs.get_config(arch).num_params() == n
    assert jcfgs.get_config(arch).num_params() == n


def test_unknown_family_raises():
    """Every family of the reference is ported; a family it does not
    know is refused."""
    cfg = dataclasses.replace(tcfgs.get_smoke("smollm-135m"), family="rnn")
    with pytest.raises(ValueError, match="unknown model family"):
        tinit.spec_tree(cfg)


def test_recurrent_init_rules():
    """recurrentgemma's RG-LRU decay parameter gives a = exp(-exp(p)) in
    [0.9, 0.999]; rwkv6's decay_base is the -6 .. -1 ramp on every layer;
    layouts are the reference's (unrolled layers, stacked blocks)."""
    cfg = dataclasses.replace(tcfgs.get_config("recurrentgemma-2b"),
                              num_layers=3, vocab_size=512)
    p = tinit.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    rec = p["layers"]["0"]["rec"]
    a = torch.exp(-torch.exp(rec["lru_a"]))
    assert a.shape == (2560,) and bool((a >= 0.9 - 1e-6).all())
    assert bool((a <= 0.999 + 1e-6).all()) and a.std() > 0.02
    assert "attn" in p["layers"]["2"] and "rec" not in p["layers"]["2"]
    assert p["layers"]["2"]["attn"]["wk"].shape == (2560, 256)
    assert torch.all(rec["conv_b"] == 0)
    cfg = dataclasses.replace(tcfgs.get_config("rwkv6-3b"), num_layers=2,
                              vocab_size=512)
    p = tinit.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tm = p["blocks"]["tm"]
    ramp = -6.0 + 5.0 * torch.arange(2560) / 2559
    assert tm["decay_base"].shape == (2, 2560)
    for layer in tm["decay_base"]:
        np.testing.assert_allclose(layer.numpy(), ramp.numpy(), atol=1e-6)
    assert tm["bonus"].shape == (2, 40, 64)
    assert torch.all(tm["decay_b"] == 0)
    assert abs(tm["mix"].std().item() - 0.02) < 2e-3


def test_moe_init_rules_and_layout():
    """deepseek-moe-16b's tree at reduced depth: one unrolled dense layer
    of width d_ff_dense, stacked MoE blocks with (E, d, f) experts and
    fan-in scaled draws, bf16 matrices under param_dtype=bf16."""
    cfg = dataclasses.replace(tcfgs.get_config("deepseek-moe-16b"),
                              num_layers=3, num_experts=4, vocab_size=512,
                              param_dtype=torch.bfloat16)
    p = tinit.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    q = tinit.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    for a, b in zip(_flat(p).values(), _flat(q).values()):
        assert torch.equal(a, b)
    assert p["dense_layers"]["0"]["mlp"]["wi"].shape == (2048, 11264)
    moe = p["blocks"]["moe"]
    assert moe["experts"]["wi"].shape == (2, 4, 2048, 1408)
    assert moe["experts"]["wo"].shape == (2, 4, 1408, 2048)
    assert moe["shared"]["wg"].shape == (2, 2048, 2 * 1408)
    assert moe["router"].shape == (2, 2048, 4)
    assert moe["experts"]["wi"].dtype == torch.bfloat16
    assert p["final_norm"].dtype == torch.float32
    wi = moe["experts"]["wi"].float()
    assert abs(wi.std().item() - 2048 ** -0.5) < 1e-3
    assert abs(moe["experts"]["wo"].float().std().item()
               - 1408 ** -0.5) < 1e-3
    # each layer and expert slice is its own draw
    assert not torch.equal(wi[0, 0], wi[0, 1])
    assert not torch.equal(wi[0], wi[1])


def test_init_rules_and_seeding():
    cfg = tcfgs.get_config("smollm-135m")
    cfg = dataclasses.replace(cfg, num_layers=2)
    p = tinit.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    q = tinit.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    for a, b in zip(_flat(p).values(), _flat(q).values()):
        assert torch.equal(a, b)                      # same seed, same params
    assert torch.all(p["final_norm"] == 1.0)
    assert torch.all(p["blocks"]["ln1"] == 1.0)
    # normal(0.02) embedding, fan-in scaled matrices (1/sqrt(d_in))
    assert abs(p["embed"]["tok"].std().item() - 0.02) < 1e-3
    wq = p["blocks"]["attn"]["wq"]
    assert abs(wq.std().item() - cfg.d_model ** -0.5) < 2e-3
    wo = p["blocks"]["mlp"]["wo"]
    assert abs(wo.std().item() - cfg.d_ff ** -0.5) < 2e-3
    assert "lm_head" not in p                         # tied embeddings


def test_qkv_bias_init_zero():
    cfg = tcfgs.get_smoke("qwen2.5-14b")
    p = tinit.init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    for name in ("bq", "bk", "bv"):
        assert p["blocks"]["attn"][name].shape[0] == cfg.num_layers
        assert torch.all(p["blocks"]["attn"][name] == 0.0)
    assert p["lm_head"].shape == (cfg.d_model, cfg.vocab_size)


@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_numpy_roundtrips_exactly(arch):
    jparams = jinit.init_params(jcfgs.get_smoke(arch), jax.random.key(0))
    tree = jax.tree.map(np.asarray, jparams)
    tp = tinit.params_from_numpy(tree, "cpu")
    ref, got = _flat(tree), _flat(tp)
    assert got.keys() == ref.keys()
    for k in ref:
        assert got[k].dtype == torch.float32
        np.testing.assert_array_equal(got[k].numpy(), ref[k])


def test_params_from_numpy_bf16_and_cast():
    a = np.asarray(jnp.asarray([[1.5, -2.25], [3.0, 0.1]], jnp.bfloat16))
    out = tinit.params_from_numpy({"w": a, "i": np.arange(3)}, "cpu")
    assert out["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(out["w"].float().numpy(),
                                  a.astype(np.float32))
    assert out["i"].dtype == torch.int64
    cast = tinit.params_from_numpy({"w": a, "i": np.arange(3)}, "cpu",
                                   dtype=torch.float32)
    assert cast["w"].dtype == torch.float32 and cast["i"].dtype == torch.int64
