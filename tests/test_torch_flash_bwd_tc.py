"""The host side of the flash backward's tensor-core instance, on the CPU
(the kernel itself runs only on the card: ``test_torch_kernels_cuda.py``,
``chip_smoke.py``):

* the rounding model, ``attention_bwd_ref(..., operand_dtype=...)``:
  without it every result is the same bit for bit as the formula before
  it existed; fp32 operands on fp32 inputs change nothing; bf16 operands
  round P before dV = P^T dO and dS before dK and dQ (checked against
  einsums written out here), and move the fp32 result by a non-zero
  distance within bf16 resolution;
* the dispatch: which instance ``flash_attention_bwd`` takes for given
  tensors (bf16 at head_dim 64 / 128 with 16-byte aligned rows: the
  tensor cores; fp32, an offset or odd-strided view, or head_dim 256:
  the CUDA cores), including the tensors the model's training path hands
  the backward;
* the C ABI: every ``extern "C"`` entry of ``kernels/csrc/*.cu`` against
  the ctypes argument list its wrapper passes to ``C.entry`` (a drift
  there corrupts arguments on the card without an error).
"""
import ast
import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.kernels import _ctypes as C  # noqa: E402
from repro_torch.kernels.flash_attention import \
    flash_attention as fmod  # noqa: E402
from repro_torch.kernels.flash_attention import ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    _scores, attention_bwd_ref, attention_ref)
from repro_torch.models.attention import self_attention  # noqa: E402

KERNELS = Path(fmod.__file__).resolve().parents[1]

# (b, hq, hkv, sq, d, causal, window)
CASES = [(1, 6, 2, 40, 64, True, 0), (2, 4, 4, 33, 128, True, 12),
         (1, 3, 1, 25, 64, False, 7)]
IDS = [f"hq{c[1]}-hkv{c[2]}-s{c[3]}-d{c[4]}-"
       f"{'causal' if c[5] else 'full'}-w{c[6]}" for c in CASES]


def _inputs(dtype, b, hq, hkv, sq, d, causal, window, seed=0):
    """(b, h, s, d) views of the model's layout, and the plain forward's
    output and LSE."""
    rng = np.random.default_rng(seed)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(
        (b, sq, h, d)).astype(np.float32)).to(dtype).transpose(1, 2)
        for h in (hq, hkv, hkv, hq))
    o, lse = attention_ref(q, k, v, causal=causal, window=window,
                           return_lse=True)
    return q, k, v, o, lse, do


def _bwd_before(q, k, v, o, lse, do, causal, window):
    """``attention_bwd_ref`` as it was before ``operand_dtype``."""
    b, hq, sq, d = q.shape
    hkv = k.shape[1]
    g = hq // hkv
    s, mask = _scores(q, k, causal, window)
    lse = lse.float().reshape(b, hkv, g, sq, 1)
    p = torch.where(mask, torch.exp(s - lse), torch.zeros_like(s))
    dof = do.float().reshape(b, hkv, g, sq, d)
    dv = torch.einsum("bhgqk,bhgqd->bhkd", p, dof)
    dp = torch.einsum("bhgqd,bhkd->bhgqk", dof, v.float())
    delta = torch.sum(dof * o.float().reshape(b, hkv, g, sq, d), dim=-1,
                      keepdim=True)
    ds = p * (dp - delta)
    scale = d ** -0.5
    dq = torch.einsum("bhgqk,bhkd->bhgqd", ds, k.float()) * scale
    dk = torch.einsum("bhgqk,bhgqd->bhkd", ds,
                      q.float().reshape(b, hkv, g, sq, d)) * scale
    return (dq.reshape(b, hq, sq, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def _rel_dist(a, b):
    return (torch.linalg.vector_norm(a.float() - b.float())
            / torch.linalg.vector_norm(b.float())).item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_rounding_model_off_by_default(dtype, case):
    """No ``operand_dtype`` (or None) gives the results of the formula
    before it, bit for bit; fp32 operands on fp32 inputs change
    nothing."""
    *shape, causal, window = case
    args = _inputs(dtype, *shape, causal, window)
    kw = dict(causal=causal, window=window)
    want = _bwd_before(*args, causal, window)
    for got in (attention_bwd_ref(*args, **kw),
                attention_bwd_ref(*args, **kw, operand_dtype=None)):
        assert all(torch.equal(a, w) for a, w in zip(got, want))
    if dtype == torch.float32:
        got = attention_bwd_ref(*args, **kw, operand_dtype=torch.float32)
        assert all(torch.equal(a, w) for a, w in zip(got, want))


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_rounding_model_rounds_p_and_ds(case):
    """bf16 operands: dV is the product of the bf16-rounded P with dO,
    dQ and dK those of the bf16-rounded dS with K and Q, summed in fp32;
    on fp32 inputs the model lands a non-zero distance from the exact
    fp32 backward, within bf16 resolution."""
    (b, hq, hkv, sq, d), causal, window = case[:5], case[5], case[6]
    q, k, v, o, lse, do = _inputs(torch.bfloat16, b, hq, hkv, sq, d,
                                  causal, window, seed=1)
    kw = dict(causal=causal, window=window)
    dq, dk, dv = attention_bwd_ref(q, k, v, o, lse, do, **kw,
                                   operand_dtype=torch.bfloat16)
    g = hq // hkv
    s, mask = _scores(q, k, causal, window)
    p = torch.where(mask, torch.exp(s - lse.reshape(b, hkv, g, sq, 1)),
                    torch.zeros_like(s))
    dof = do.float().reshape(b, hkv, g, sq, d)
    pr = p.to(torch.bfloat16).float()
    assert not torch.equal(pr, p)
    assert torch.equal(dv, torch.einsum("bhgqk,bhgqd->bhkd", pr, dof)
                       .to(torch.bfloat16))
    dp = torch.einsum("bhgqd,bhkd->bhgqk", dof, v.float())
    delta = torch.sum(dof * o.float().reshape(b, hkv, g, sq, d), dim=-1,
                      keepdim=True)
    dsr = (p * (dp - delta)).to(torch.bfloat16).float()
    assert torch.equal(dq, (torch.einsum("bhgqk,bhkd->bhgqd", dsr, k.float())
                            * d ** -0.5).reshape(b, hq, sq, d)
                       .to(torch.bfloat16))
    assert torch.equal(dk, (torch.einsum(
        "bhgqk,bhgqd->bhkd", dsr, q.float().reshape(b, hkv, g, sq, d))
        * d ** -0.5).to(torch.bfloat16))
    # on the same inputs in fp32: only P and dS are rounded
    up = [t.float() for t in (q, k, v, o, lse, do)]
    model = attention_bwd_ref(*up, **kw, operand_dtype=torch.bfloat16)
    exact = attention_bwd_ref(*up, **kw)
    for m, x, name in zip(model, exact, ("dq", "dk", "dv")):
        assert m.dtype == torch.float32
        assert 0 < _rel_dist(m, x) < 2 ** -7, name


def _view(d, dtype=torch.bfloat16, offset=0, pad=0, h=3, s=20):
    """A (1, h, s, d) view of a (1, s, h, d + pad) buffer that starts
    ``offset`` elements into its storage."""
    flat = torch.zeros(s * h * (d + pad) + offset, dtype=dtype)[offset:]
    return flat.view(1, s, h, d + pad)[..., :d].transpose(1, 2)


def test_bwd_instance_choice():
    """bf16 at head_dim 64, 128 and 256 (recurrentgemma-2b's) with every
    tensor's rows 16-byte aligned takes the tensor cores; fp32, a view 4
    elements into its storage (q, o or do) and rows of d + 4 elements
    take the CUDA cores."""
    assert fmod.BWD_HEAD_DIMS == (64, 128, 256)
    for d in (64, 128, 256):
        five = [_view(d) for _ in range(5)]
        assert fmod.bwd_instance(*five) == "tc"
        assert fmod.bwd_instance(*(_view(d, torch.float32),) * 5) \
            == "cuda_core"
        for i in (0, 3, 4):                  # q, o, do
            t = list(five)
            t[i] = _view(d, offset=4)
            assert fmod.bwd_instance(*t) == "cuda_core"
        odd = _view(d, pad=4)
        assert odd.stride(2) % 8 and fmod.bwd_instance(
            odd, *five[1:]) == "cuda_core"
        # gradients the caller hands in are held to the same rule
        grads = (_view(d), _view(d), _view(d, offset=4))
        assert fmod.bwd_instance(*five, grads=grads) == "cuda_core"
    # the forward's instance keeps its own head dims
    assert fmod.instance(*(_view(256) for _ in range(3))) == "tc"


def test_training_path_hands_the_backward_tc_tensors(monkeypatch):
    """The model's attention in bf16 (projections reshaped to (b, s, h, d)
    and viewed as (b, h, s, d), RoPE) through the autograd Function: the
    q, k, v, o and incoming do its backward receives take the
    tensor-core instance."""
    cfg = dataclasses.replace(get_smoke("smollm-135m"), num_heads=3,
                              num_kv_heads=1, head_dim=64, d_model=96,
                              compute_dtype=torch.bfloat16)
    rng = np.random.default_rng(2)
    b, s, dm = 2, 24, cfg.d_model
    x = torch.from_numpy(rng.standard_normal((b, s, dm)).astype(
        np.float32)).to(torch.bfloat16)
    p = {n: torch.from_numpy((0.05 * rng.standard_normal(shape)).astype(
        np.float32)).to(torch.bfloat16).requires_grad_()
        for n, shape in (("wq", (dm, 3 * 64)), ("wk", (dm, 64)),
                         ("wv", (dm, 64)), ("wo", (3 * 64, dm)))}
    seen = []

    def spy(q, k, v, o, lse, do, **kw):
        seen.append(fmod.bwd_instance(q, k, v, o, do))
        return attention_bwd_ref(q, k, v, o, lse, do, **kw)

    monkeypatch.setattr(ops, "attention_bwd_ref", spy)
    out, _ = self_attention(x, p, cfg)
    out.float().square().sum().backward()
    assert seen == ["tc"]
    assert all(torch.isfinite(p[n].grad.float()).all() for n in p)


_KINDS = {C.P: "pointer", C.I: "int", C.LL: "long long", C.F: "float"}


def _c_kind(param: str) -> str:
    param = " ".join(param.split())
    if "*" in param:
        return "pointer"
    words = param.replace("const ", "").split()[:-1]
    return " ".join(words)


def _c_entries():
    """{symbol: (source, [parameter kinds])} of every extern "C" function
    in kernels/csrc/*.cu."""
    out = {}
    for src in sorted((KERNELS / "csrc").glob("*.cu")):
        text = re.sub(r"//[^\n]*", "", src.read_text())
        for m in re.finditer(r'extern "C"\s+[\w\s\*]+?\b(\w+)\s*\(([^)]*)\)',
                             text):
            out[m.group(1)] = (src.stem, [_c_kind(p)
                                          for p in m.group(2).split(",")])
    return out


def _py_bindings():
    """{symbol: (kernel, ctypes argtypes)} of every ``C.entry`` call in
    the kernels' wrappers."""
    import importlib

    out = {}
    for path in sorted(KERNELS.glob("*/*.py")):
        mod = importlib.import_module(
            "repro_torch.kernels." + ".".join(
                path.relative_to(KERNELS).with_suffix("").parts))
        for node in ast.walk(ast.parse(path.read_text())):
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "entry"
                    and getattr(node.func.value, "id", None) == "C"):
                kernel, symbol = (a.value for a in node.args[:2])
                out[symbol] = (kernel, getattr(mod, node.args[2].id))
    return out


def test_c_entry_points_match_their_ctypes_arguments():
    entries, bindings = _c_entries(), _py_bindings()
    assert "repro_flash_attention_bwd_tc" in entries
    assert set(entries) == set(bindings)
    for symbol, (kernel, argtypes) in bindings.items():
        src, kinds = entries[symbol]
        assert src == kernel, symbol
        assert [_KINDS[t] for t in argtypes] == kinds, symbol
