"""The port stands alone: ``src/repro_torch``, ``chip_smoke.py``, the
card-only tests and the port's examples import neither JAX nor anything
of the JAX package, and the port's entry points run on the card unless
the caller asks for the CPU."""
import ast
from pathlib import Path

import pytest
import torch

from repro_torch.models import transformer as T
from repro_torch.models.config import Family, ModelConfig
from repro_torch.serving.engine import DecodeEngine, EngineConfig
from repro_torch.serving.orchestrator import Orchestrator, OrchestratorConfig

ROOT = Path(__file__).resolve().parents[1]
SOURCES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py", ROOT / "tests" / "test_torch_cuda.py",
       ROOT / "examples" / "torch_train_lm.py",
       ROOT / "examples" / "torch_quickstart.py",
       ROOT / "examples" / "torch_serve_disaggregated.py",
       ROOT / "examples" / "torch_simulate_cluster.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")
CFG = ModelConfig(name="iso", family=Family.DENSE, n_layers=1, d_model=32,
                  n_heads=2, n_kv_heads=1, d_ff=64, vocab_size=64)


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_sources_are_found():
    names = {p.name for p in SOURCES}
    assert {"chip_smoke.py", "layers.py", "orchestrator.py",
            "split_kv_decode.py", "flash_prefill.py", "mesh.py",
            "sharding.py", "pipeline_decode.py",
            "torch_serve_disaggregated.py"} <= names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(
    p.relative_to(ROOT)))
def test_no_jax_and_no_reference_package(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_entry_points_need_a_card_unless_cpu_is_asked(monkeypatch):
    """With no card, the default device raises; ``device="cpu"`` runs.
    Nothing falls back to the CPU on its own."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.init(CFG)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.init_paged_cache(CFG, 1, 32, 8)
    params = T.init(CFG, device="cpu")
    ocfg = OrchestratorConfig(n_prefill=1, n_decode=1,
                              engine=EngineConfig(max_len=32, max_batch=1,
                                                  block_size=8))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Orchestrator(CFG, params, ocfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DecodeEngine(CFG, params, ocfg.engine)
    orch = Orchestrator(CFG, params, ocfg, device="cpu")
    assert orch.device.type == "cpu"
