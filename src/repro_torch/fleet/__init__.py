"""The port's copy of ``repro.fleet``, unchanged in behaviour: the fleet
simulator (``sim``, its ``vectorized`` engine, ``cluster``, ``job``,
``policies``), its workloads and scenario presets, JSONL traces, the
what-if advisor, the adaptive controller and the adversarial scenario
search.  It is host code: plain Python over the simulated TPU fleet of
``generations``, with no tensor in it.

The package exports what the reference's does.  The exports load on
first use, so that ``parallel.reshard`` (which the simulator imports) can
read ``fleet.generations`` without importing the simulator first.
``fleet.trace`` is not re-exported: it doubles as the ``python -m
repro_torch.fleet.trace`` CLI.
"""
from __future__ import annotations

import importlib

_EXPORTS = {
    "Cluster": "cluster",
    "JobSpec": "job", "SIZE_CLASSES": "job",
    "DEFRAG_POLICIES": "policies", "PLACEMENT_POLICIES": "policies",
    "PREEMPTION_POLICIES": "policies", "DefragPolicy": "policies",
    "PlacementPolicy": "policies", "PreemptionPolicy": "policies",
    "SCENARIOS": "scenarios", "Scenario": "scenarios",
    "build_sim": "scenarios", "golden_sim": "scenarios",
    "FleetSim": "sim", "SimConfig": "sim",
}
__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}")
    return getattr(importlib.import_module(f"{__name__}.{_EXPORTS[name]}"),
                   name)
