"""The port stands alone: nothing under ``src/repro_torch/`` nor
``chip_smoke.py`` imports JAX or the JAX package ``repro``, and its entry
points refuse to run on the CPU unless the caller asks for it."""
import ast
from pathlib import Path

import pytest
import torch

import repro_torch.configs as TC
from repro_torch.models import model as TM
from repro_torch.serving.engine import InferenceEngine
from repro_torch.serving.kvcache import PagedCacheSlots

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imported(tree: ast.AST):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module:
                yield node.module


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_import(path):
    bad = [m for m in _imported(ast.parse(path.read_text()))
           if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_boundary_rule_itself():
    tree = ast.parse("import jax.numpy as jnp\nfrom repro.configs import x\n"
                     "from repro_torch import kernels\nimport reprox\n")
    assert [m for m in _imported(tree) if _forbidden(m)] == [
        "jax.numpy", "repro.configs"]


def test_entry_points_refuse_cpu_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    cfg = TC.scaled_down(TC.get_config("qwen1.5-4b"), num_layers=1)
    params = TM.init(cfg, seed=0, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        InferenceEngine(cfg, params)
    with pytest.raises(RuntimeError):
        TM.init(cfg, seed=0)
    with pytest.raises(RuntimeError):
        TM.make_paged_pool(cfg, 4, 16)
    with pytest.raises(RuntimeError):
        PagedCacheSlots(cfg, 2, 32)
    InferenceEngine(cfg, params, device="cpu")      # asked for: fine
