"""Flash attention of the port: its plain version against the reference's
oracle (``attention_ref``), the reference's XLA chunked ``attention``
(attn_chunk=8) and the Pallas kernel in interpret mode, on the same numpy
inputs in fp32.  Covers GQA with g=3 and g=10 (recurrentgemma's MQA at
head_dim 256), causal, sliding windows and ragged sequence lengths.  The
CUDA kernel itself is held against the plain version on the card
(test_torch_kernels_cuda.py, chip_smoke.py).

Tolerance 1e-5 (atol and rtol): the same fp32 arithmetic in another
summation order.
"""
import inspect
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention.flash_attention import \
    flash_attention as pallas_flash  # noqa: E402
from repro.kernels.flash_attention.ref import \
    attention_ref as jax_ref  # noqa: E402
from repro.models.attention import attention as jax_attention  # noqa: E402
from repro_torch.kernels.flash_attention import \
    flash_attention as kmod  # noqa: E402
from repro_torch.kernels.flash_attention.ops import \
    flash_attention_bshd  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro_torch.serve.kv_cache import FLASH_ATTENTION_BLOCK_K  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)

# (b, hq, hkv, sq, d, causal, window)
CASES = [
    (1, 3, 1, 1, 16, True, 0),
    (2, 3, 1, 127, 16, True, 0),       # g=3, one ragged tile
    (1, 9, 3, 129, 16, True, 0),       # g=3, smollm's head ratio
    (1, 9, 3, 300, 16, True, 0),       # three tiles, ragged tail
    (2, 6, 3, 200, 32, True, 48),      # sliding window across tiles
    (1, 4, 4, 96, 16, False, 0),       # MHA, non-causal
    (1, 10, 1, 40, 256, True, 16),     # recurrentgemma: d 256, MQA g=10
]


def _inputs(b, hq, hkv, sq, d, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hq, sq, d)).astype(np.float32)
    k = rng.standard_normal((b, hkv, sq, d)).astype(np.float32)
    v = rng.standard_normal((b, hkv, sq, d)).astype(np.float32)
    return q, k, v


def _port_ref(q, k, v, causal, window):
    return attention_ref(*(torch.from_numpy(a) for a in (q, k, v)),
                         causal=causal, window=window).numpy()


@pytest.mark.parametrize("b,hq,hkv,sq,d,causal,window", CASES)
def test_plain_matches_reference_oracle(b, hq, hkv, sq, d, causal, window):
    q, k, v = _inputs(b, hq, hkv, sq, d, seed=sq + d)
    ref = np.asarray(jax_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             causal=causal, window=window))
    np.testing.assert_allclose(_port_ref(q, k, v, causal, window), ref, **TOL)


@pytest.mark.parametrize("b,hq,hkv,sq,d,causal,window", CASES)
def test_ops_bshd_matches_reference_xla_attention(b, hq, hkv, sq, d, causal,
                                                  window):
    """The model-layout wrapper (impl="auto" on CPU tensors = the plain
    version) against the XLA attention the reference's prefill runs;
    chunk=8 takes its chunked path wherever sq % 8 == 0."""
    q, k, v = (a.transpose(0, 2, 1, 3).copy()
               for a in _inputs(b, hq, hkv, sq, d, seed=sq + d + 1))
    ref = np.asarray(jax_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal=causal,
                                   window=window, chunk=8))
    out = flash_attention_bshd(*(torch.from_numpy(a) for a in (q, k, v)),
                               causal=causal, window=window)
    np.testing.assert_allclose(out.numpy(), ref, **TOL)


@pytest.mark.parametrize("b,hq,hkv,sq,d,causal,window",
                         [c for c in CASES if c[5]])
def test_plain_matches_pallas_kernel_interpret(b, hq, hkv, sq, d, causal,
                                               window):
    """The Pallas kernel (interpret mode, 128x128 tiles) reads past the
    end of a ragged last tile, so its inputs are zero-padded to whole
    tiles; for causal attention the padded keys lie after every real
    query and are masked, so the real rows are exact."""
    q, k, v = _inputs(b, hq, hkv, sq, d, seed=sq + d + 2)
    n = -(-sq // 128) * 128 if sq > 128 else sq
    pad = [(0, 0), (0, 0), (0, n - sq), (0, 0)]
    out = pallas_flash(*(jnp.asarray(np.pad(a, pad)) for a in (q, k, v)),
                       causal=True, window=window, interpret=True)
    ref = np.asarray(out)[:, :, :sq]
    np.testing.assert_allclose(_port_ref(q, k, v, True, window), ref, **TOL)


def test_kernel_refuses_cpu_tensors():
    """A kernel call on host tensors raises; only impl="auto"/"ref" reach
    the plain version there — no silent fallback either way."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 3, 1, 8, 64, 0))
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_bshd(q, k, v, impl="kernel")
    with pytest.raises(ValueError, match="unknown"):
        flash_attention_bshd(q, k, v, impl="pallas")
    assert kmod.LAUNCHES == 0


def test_block_k_pinned_to_allocator_page_and_cuda_source():
    """The kernel's kv tile for head_dim <= 128 is the serve allocator's
    page size (as the reference pins the Pallas block_k), in Python and in
    the .cu; head_dim 256 runs a 64-key tile (shared memory), which no
    page size depends on."""
    from repro.kernels.flash_attention.flash_attention import flash_attention

    assert kmod.BLOCK_K == FLASH_ATTENTION_BLOCK_K == 128
    assert inspect.signature(flash_attention).parameters[
        "block_k"].default == FLASH_ATTENTION_BLOCK_K
    src = (Path(kmod.__file__).parents[1] / "csrc"
           / "flash_attention.cu").read_text()
    assert int(re.search(r"kBK = (\d+);", src).group(1)) == kmod.BLOCK_K
    assert int(re.search(r"kBK256 = (\d+);", src).group(1)) == 64
    assert 256 in kmod.HEAD_DIMS


def test_instance_choice():
    """bf16 at head_dim 64, 128 and 256 (the model's (b, s, h, d) tensors
    viewed as (b, h, s, d), strides in multiples of 8) takes the
    tensor-core instance; fp32, head_dim 16 / 32 and a misaligned view
    take the CUDA-core one."""
    def view(d, dtype=torch.bfloat16, offset=0, h=3, s=20):
        flat = torch.zeros(s * h * d + offset, dtype=dtype)[offset:]
        return flat.view(1, s, h, d).transpose(1, 2)

    for d in (64, 128, 256):
        assert kmod.instance(view(d), view(d), view(d)) == "tc"
        assert kmod.instance(*(view(d, torch.float32),) * 3) == "cuda_core"
        assert kmod.instance(view(d, offset=4), view(d), view(d)) \
            == "cuda_core"
    for d in (16, 32):
        assert kmod.instance(view(d), view(d), view(d)) == "cuda_core"
    assert kmod.TC_HEAD_DIMS == (64, 128, 256)
