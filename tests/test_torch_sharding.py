"""The port's distribution rules against the reference's, in one process
(no ranks, no devices): the mesh is a stand-in carrying axis names and
sizes, which is all the rules read.

* every ParamSpec's logical axes equal the reference's ``spec_tree``'s,
  for all ten configs (full and SMOKE);
* ``assign_axes`` equals the reference's over every leaf on 16 x 16, 2 x
  16 x 16, ``canonical_mesh(8)`` and ``canonical_mesh(4)``, and
  ``canonical_mesh`` itself for 1..64 chips;
* ``sharded_param_bytes`` equals the reference's on 16 x 16;
* ``batch_placements`` / ``cache_placements`` give the reference's
  ``batch_pspecs`` / ``cache_pspecs`` on the reference's SMOKE train
  batches and decode caches of every family;
* ``ParallelCtx.spec`` equals the reference's for every kind, with and
  without pod and the sequence axis;
* ``moe_dispatch`` (``moe_block``'s choice) equals the reference's
  ``moe_block`` over experts, d_ff, model sizes and ``moe_impl``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as ref_config  # noqa: E402
from repro.configs import get_smoke as ref_smoke  # noqa: E402
from repro.models import model as ref_model  # noqa: E402
from repro.models.config import ShapeConfig as RefShape  # noqa: E402
from repro.models.init import param_specs as ref_param_specs  # noqa: E402
from repro.parallel import reshard as ref_reshard  # noqa: E402
from repro.parallel import sharding as ref_sharding  # noqa: E402
from repro.parallel.ctx import ParallelCtx as RefCtx  # noqa: E402
from repro_torch.configs import get_config, get_smoke  # noqa: E402
from repro_torch.models.init import param_specs  # noqa: E402
from repro_torch.parallel import reshard, sharding  # noqa: E402
from repro_torch.parallel.ctx import ParallelCtx  # noqa: E402
from repro_torch.parallel.moe_ep import moe_dispatch  # noqa: E402

ARCHS = ("deepseek-moe-16b", "granite-3-8b", "llava-next-mistral-7b",
         "mixtral-8x7b", "qwen2-72b", "qwen2.5-14b", "recurrentgemma-2b",
         "rwkv6-3b", "smollm-135m", "whisper-medium")
MESHES = {
    "16x16": {"data": 16, "model": 16},
    "2x16x16": {"pod": 2, "data": 16, "model": 16},
    "canonical8": reshard.canonical_mesh(8),
    "canonical4": reshard.canonical_mesh(4),
}
SMALL = {"2x2": {"data": 2, "model": 2},
         "2x2x2": {"pod": 2, "data": 2, "model": 2},
         "16x16": {"data": 16, "model": 16}}


class FakeMesh:
    """Axis names and sizes: the reference's ``axis_names`` /
    ``devices.shape`` and the port's ``mesh_dim_names`` / ``shape``."""

    def __init__(self, axes):
        self.axis_names = self.mesh_dim_names = tuple(axes)
        self.shape = tuple(axes.values())
        self.devices = np.empty(self.shape)


def _tuple(pspec):
    return tuple(tuple(p) if isinstance(p, (list, tuple)) else p
                 for p in pspec)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_axes_match_reference(arch):
    for ref_cfg, cfg in ((ref_config(arch), get_config(arch)),
                         (ref_smoke(arch), get_smoke(arch))):
        ref, got = ref_param_specs(ref_cfg), param_specs(cfg)
        assert ref.keys() == got.keys()
        for name in ref:
            assert got[name].axes == ref[name].axes, name


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_assign_axes_matches_reference(arch, mesh):
    axes = MESHES[mesh]
    for name, spec in param_specs(get_config(arch)).items():
        assert reshard.assign_axes(spec.shape, spec.axes, axes) == \
            ref_reshard.assign_axes(spec.shape, spec.axes, axes), name


def test_canonical_mesh_matches_reference():
    for chips in range(1, 65):
        assert reshard.canonical_mesh(chips) == \
            ref_reshard.canonical_mesh(chips)
    assert reshard.DEFAULT_RULES == ref_reshard.DEFAULT_RULES


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_param_bytes_matches_reference(arch):
    mesh = MESHES["16x16"]
    assert sharding.sharded_param_bytes(get_config(arch), mesh) == \
        ref_sharding.sharded_param_bytes(ref_config(arch), FakeMesh(mesh))


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def _meta(tree):
    """The reference's abstract tree as ``meta`` tensors of its shapes."""
    if isinstance(tree, dict):
        return {k: _meta(v) for k, v in tree.items()}
    return torch.empty(tuple(tree.shape), device="meta")


@pytest.mark.parametrize("mesh", list(SMALL))
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_and_cache_placements_match_reference(arch, mesh):
    """The rules over the reference's own input and cache trees (the
    port's caches keep a per-row ``pos``, where whisper's reference has a
    scalar, and whisper's ``ring``)."""
    axes, fake = SMALL[mesh], FakeMesh(SMALL[mesh])
    rcfg, cfg = ref_smoke(arch), get_smoke(arch)
    for kind, b in (("train", 4), ("train", 1), ("decode", 4)):
        ref = ref_model.input_specs(rcfg, RefShape("c", kind, 32, b))
        if kind == "decode":
            got_p = {"token": sharding.batch_placements(
                         _meta(ref["token"]), axes),
                     "cache": sharding.cache_placements(
                         cfg, _meta(ref["cache"]), axes)}
            ref_p = {"token": ref_sharding.batch_pspecs(
                         rcfg, ref["token"], fake),
                     "cache": ref_sharding.cache_pspecs(
                         rcfg, ref["cache"], fake)}
        else:
            got_p = sharding.batch_placements(_meta(ref), axes)
            ref_p = ref_sharding.batch_pspecs(rcfg, ref, fake)
        ref_flat, got_flat = dict(_paths(ref_p)), dict(_paths(got_p))
        assert ref_flat.keys() == got_flat.keys()
        for path, want in ref_flat.items():
            assert got_flat[path] == _tuple(want), (kind, path)


@pytest.mark.parametrize("mesh", ["2x2", "2x2x2"])
@pytest.mark.parametrize("sp", [None, "model"])
def test_ctx_spec_matches_reference(mesh, sp):
    fake = FakeMesh(SMALL[mesh])
    ref = RefCtx(fake, dp_axes=("pod", "data"), sp_axis=sp)
    got = ParallelCtx(fake, dp_axes=("pod", "data"), sp_axis=sp)
    for kind in ("tokens", "act", "act_heads", "logits", "cache",
                 "cache_batch", "kv_rep", "act_rnn"):
        assert got.spec(kind) == _tuple(ref.spec(kind)), kind
    with pytest.raises(KeyError):
        got.spec("nope")


@pytest.mark.parametrize("impl", ["ep", "gspmd"])
def test_moe_dispatch_matches_reference(monkeypatch, impl):
    import repro.models.moe as ref_moe
    import repro.parallel.moe_ep as ref_ep

    monkeypatch.setattr(ref_ep, "moe_ep", lambda *a: "ep")
    monkeypatch.setattr(ref_ep, "moe_tp", lambda *a: "tp")
    monkeypatch.setattr(ref_moe, "moe_gspmd", lambda *a: "gspmd")
    seen = set()
    for experts in (6, 8, 64):
        for d_ff in (30, 32, 96):
            for model_size in (1, 2, 4, 16):
                axes = {"data": 2, "model": model_size}
                rcfg = dataclasses.replace(ref_smoke("mixtral-8x7b"),
                                           num_experts=experts, d_ff=d_ff,
                                           moe_impl=impl)
                cfg = dataclasses.replace(get_smoke("mixtral-8x7b"),
                                          num_experts=experts, d_ff=d_ff,
                                          moe_impl=impl)
                want = ref_moe.moe_block(None, None, rcfg, FakeMesh(axes))
                assert moe_dispatch(cfg, axes) == want
                seen.add(want)
    assert moe_dispatch(cfg, None) == "gspmd"
    assert seen == ({"ep", "tp", "gspmd"} if impl == "ep" else {"gspmd"})
