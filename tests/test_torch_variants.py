"""The port's named variants (``repro_torch.launch.variants``) against
the reference's, on the CPU (exact comparisons, no tolerance).

* ``VARIANTS`` has the reference's names; every variant the port accepts
  gives the reference's field values (dtypes by name), those setting a
  mesh knob (read by the sharded step) included; every variant that
  sets a knob no code of the port reads (``attn_chunk``,
  ``decode_unroll``) raises ``ValueError`` naming the knob.
* No module of the port reads a knob ``apply_variant`` refuses (the cost
  reference's seq points read ``attn_chunk`` as the reference's do; they
  label no run); each mesh knob has a reader.
"""
import dataclasses
import pathlib
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_smoke as jsmoke  # noqa: E402
from repro.launch import variants as jvar  # noqa: E402
from repro_torch.configs import get_smoke as tsmoke  # noqa: E402
from repro_torch.launch import variants as tvar  # noqa: E402

# the variants setting a mesh knob, read by the sharded step
MESH_VARIANTS = ["moe_shard_map", "no_sp", "kv_gather", "bf16_grads",
                 "moe_sm_mb4", "moe_sm_mb4_losschunk", "moe_sm_losschunk",
                 "kv_bf16", "dense_opt", "moe_opt", "kvg_opt", "mb2_lc",
                 "mb8_lc"]
MESH_KNOBS = ("moe_impl", "seq_shard_activations", "attn_kv_gather",
              "bf16_grad_reduce")
ACCEPTED = ["baseline", "microbatch2", "microbatch4", "microbatch8",
            "loss_chunk512", "no_remat", "mb4_losschunk",
            "serve_bf16"] + MESH_VARIANTS
REFUSED = sorted(set(jvar.VARIANTS) - set(ACCEPTED))
UNREAD = ("attn_chunk", "decode_unroll")
PORT = pathlib.Path(tvar.__file__).resolve().parents[1]


def _fields(cfg):
    """Field values, dtypes by name (``torch.bfloat16`` / jnp's)."""
    out = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if isinstance(v, torch.dtype):
            v = str(v).split(".")[-1]
        elif f.name in ("param_dtype", "compute_dtype"):
            v = np.dtype(v).name
        out[f.name] = v
    return out


def test_variant_names_match_reference():
    assert list(tvar.VARIANTS) == list(jvar.VARIANTS)
    assert len(REFUSED) == len(jvar.VARIANTS) - len(ACCEPTED)


@pytest.mark.parametrize("name", ACCEPTED)
@pytest.mark.parametrize("arch", ["smollm-135m", "deepseek-moe-16b",
                                  "whisper-medium"])
def test_accepted_variant_matches_reference(arch, name):
    t = tvar.apply_variant(tsmoke(arch), name)
    j = jvar.apply_variant(jsmoke(arch), name)
    assert _fields(t) == _fields(j)


@pytest.mark.parametrize("name", REFUSED)
def test_refused_variant_names_its_knob(name):
    knobs = [k for k in UNREAD
             if getattr(jvar.apply_variant(jsmoke("smollm-135m"), name), k)
             != getattr(jsmoke("smollm-135m"), k)]
    assert knobs, f"{name} sets no unread knob"
    with pytest.raises(ValueError) as e:
        tvar.apply_variant(tsmoke("smollm-135m"), name)
    for k in knobs:
        assert k in str(e.value)
    assert any(w in str(e.value)
               for w in ("distribution", "chunking", "unrolled"))


@pytest.mark.parametrize("name", MESH_VARIANTS)
def test_mesh_variant_sets_its_knob(name):
    """A variant setting a mesh knob is accepted and sets it as the
    reference's does."""
    base = jsmoke("smollm-135m")
    want = jvar.apply_variant(base, name)
    knobs = [k for k in MESH_KNOBS if getattr(want, k) != getattr(base, k)]
    assert knobs, f"{name} sets no mesh knob"
    got = tvar.apply_variant(tsmoke("smollm-135m"), name)
    for k in knobs:
        assert getattr(got, k) == getattr(want, k), k


def test_unknown_variant_raises_key_error():
    with pytest.raises(KeyError):
        tvar.apply_variant(tsmoke("smollm-135m"), "no_such_variant")


def test_unread_knobs_are_the_module_table():
    assert tuple(tvar.UNREAD_KNOBS) == UNREAD


def _readers(knob):
    pat = re.compile(rf"\.{knob}\b|[\"']{knob}[\"']")
    return [f"{f.relative_to(PORT)}:{i}"
            for f in sorted(PORT.rglob("*.py"))
            if f.name != "variants.py"
            for i, line in enumerate(f.read_text().splitlines(), 1)
            if pat.search(line)]


@pytest.mark.parametrize("knob", UNREAD)
def test_unread_knob_has_no_reader(knob):
    readers = _readers(knob)
    if knob == "attn_chunk":        # the cost reference's seq points
        readers = [r for r in readers if not r.startswith("core/costref.py")]
    assert readers == []


@pytest.mark.parametrize("knob", MESH_KNOBS)
def test_mesh_knob_has_a_reader(knob):
    assert _readers(knob)
