"""Boundaries of the port: it imports neither JAX nor the reference
package, and its entry points refuse to run on the host unless asked."""
import ast
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_no_jax_or_reference_imports(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), f"{path}: {mod}"


def test_port_has_modules_and_smoke_script():
    names = {p.relative_to(ROOT / "src").as_posix() for p in PORT_FILES[:-1]}
    assert {"repro_torch/serve/batched_executor.py",
            "repro_torch/launch/serve.py",
            "repro_torch/kernels/paged_attention/paged_attention.py",
            "repro_torch/kernels/flash_attention/flash_attention.py",
            "repro_torch/kernels/moe_gmm/moe_gmm.py",
            "repro_torch/models/moe.py",
            "repro_torch/serve/slot_executor.py",
            "repro_torch/serve/prefill_graph.py",
            "repro_torch/kernels/rglru_scan/rglru_scan.py",
            "repro_torch/kernels/rwkv6_wkv/rwkv6_wkv.py",
            "repro_torch/models/rglru.py",
            "repro_torch/models/rwkv.py",
            "repro_torch/tree.py",
            "repro_torch/optim/adamw.py",
            "repro_torch/optim/schedules.py",
            "repro_torch/data/pipeline.py",
            "repro_torch/launch/strategy.py",
            "repro_torch/launch/train.py",
            "repro_torch/runtime/compile_cache.py",
            "repro_torch/runtime/checkpoint.py",
            "repro_torch/runtime/orchestrator.py",
            "repro_torch/fleet/scenarios.py",
            "repro_torch/fleet/workload.py",
            "repro_torch/configs/granite_3_8b.py",
            "repro_torch/configs/qwen2_72b.py",
            "repro_torch/models/whisper.py",
            "repro_torch/configs/whisper_medium.py",
            "repro_torch/configs/llava_next_mistral_7b.py"} <= names
    csrc = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
    assert (csrc / "flash_attention_bwd.cu").exists()
    assert PORT_FILES[-1].exists()


def test_resolve_device_raises_without_cuda(monkeypatch):
    from repro_torch.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def test_entry_points_raise_without_cuda(monkeypatch):
    from repro_torch.configs import get_smoke
    from repro_torch.launch.serve import Server, main
    from repro_torch.launch.train import main as train_main
    from repro_torch.runtime.orchestrator import Orchestrator, RunConfig
    from repro_torch.models.init import init_params
    from repro_torch.serve.batched_executor import (TorchBatchedExecutor,
                                                    make_executor)
    from repro_torch.serve.slot_executor import TorchSlotExecutor

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_smoke("smollm-135m")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["--smoke", "--requests", "1"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TorchBatchedExecutor(cfg, 32, 2)
    rg = get_smoke("recurrentgemma-2b")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TorchSlotExecutor(rg, 32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_executor(rg, 32, 2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["--smoke", "--arch", "rwkv6-3b", "--executor", "slot"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["--smoke", "--engine", "static", "--requests", "1"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Server(cfg, 2, 32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_main(["--smoke", "--steps", "1"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Orchestrator(cfg, RunConfig(steps=1))
