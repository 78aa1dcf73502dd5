"""Where the benchmark's pieces are, found by the names in ``BENCHMARK.json``.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix; a configuration entry names its file under ``configs/``; a traffic
mix is ``traffic/<name>.json``; a per-layer metric is the module
``metrics/<name>.py``; a configuration's plain reference is the module
``configs/<reference>.py`` its file names.  Nothing here imports the
program.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_json(path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(path=None) -> dict:
    """``BENCHMARK.json`` at the root of the checkout."""
    return load_json(path or ROOT / "BENCHMARK.json")


def _named(entries: List[dict], name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r}; there are "
                   f"{', '.join(e['name'] for e in entries)}")


def workload(bench: dict, name: str) -> dict:
    return _named(bench["workloads"], name, "workload")


def config(bench: dict, name: str) -> dict:
    """The configuration's file, with ``name`` added."""
    entry = _named(bench["configs"], name, "configuration")
    return {**load_json(ROOT / entry["file"]), "name": name}


def traffic(name: str) -> dict:
    """The traffic mix ``traffic/<name>.json``, with ``name`` added."""
    return {**load_json(HERE / "traffic" / f"{name}.json"), "name": name}


def _module(path: Path, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reference(conf: dict) -> ModuleType:
    """The plain reference module that the configuration's file names."""
    return _module(HERE / "configs" / f"{conf['reference']}.py",
                   f"portbench_reference_{conf['reference']}")


def metric_module(name: str) -> ModuleType:
    """The per-layer metric's reader, ``metrics/<name>.py``."""
    return _module(HERE / "metrics" / f"{name}.py",
                   "portbench_metric_" + name.replace(".", "_")
                   .replace("-", "_"))


def metrics_of(bench: dict, cell: str, kind: str) -> List[dict]:
    """The ``end_to_end`` or ``per_layer`` metrics that the cell reports:
    those without a ``workloads`` key, and those that list the cell."""
    return [m for m in bench[kind]
            if "workloads" not in m or cell in m["workloads"]]


def limits(workload_name: str) -> Dict[str, float]:
    """The limits of the cell's compared numbers, ``limits/<cell>.json``
    (empty where the cell has none yet: no run of it is then correct)."""
    path = HERE / "limits" / f"{workload_name}.json"
    if not path.exists():
        return {}
    return {k: float(v["limit"]) for k, v in load_json(path).items()}


def units(metrics: List[dict]) -> Dict[str, str]:
    return {m["name"]: m["unit"] for m in metrics}
