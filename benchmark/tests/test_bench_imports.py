"""What the benchmark loads: no module whose top-level name is jax, jaxlib,
flax or gppvae_tpu (compared whole: gppvae_tpu_torch begins with
gppvae_tpu), and nothing of the program in the yardstick and in each
configuration's reference module."""

from __future__ import annotations

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest
from conftest import ROOT

from benchmark.harness.manifest import Manifest

DOC = json.loads((ROOT / "BENCHMARK.json").read_text())
FORBIDDEN = {"jax", "jaxlib", "flax", "gppvae_tpu"}
INDEPENDENT = ("reference", "yardstick")  # may not load the program either


def _top_level_imports(path) -> set[str]:
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            out.add(node.module.split(".")[0])
    return out


def _loaded_after(code: str) -> set[str]:
    probe = code + "\nimport sys\nprint(' '.join(sorted({m.split('.')[0] for m in sys.modules})))"
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, capture_output=True,
                         text=True, timeout=300, check=True)
    return set(out.stdout.split())


def test_no_source_imports_jax_or_the_jax_package():
    for path in (ROOT / "benchmark").rglob("*.py"):
        assert not _top_level_imports(path) & FORBIDDEN, path
        if path.relative_to(ROOT / "benchmark").parts[0] in INDEPENDENT:
            assert "gppvae_tpu_torch" not in _top_level_imports(path), path


def test_a_run_loads_neither_jax_nor_the_jax_package(tmp_path):
    code = ("import sys, torch; sys.path.insert(0, 'benchmark/tests'); "
            "from conftest import tiny_tree; from pathlib import Path; "
            "from benchmark import run; "
            f"m = tiny_tree(Path({str(tmp_path)!r})); "
            "run.run_cell(m, 'faces128_train', 3, 0.1, True, torch.device('cpu')); "
            "run.run_cell(m, 'faces128_serve', 3, 0.1, True, torch.device('cpu')); "
            "assert not run.forbidden_modules()")
    loaded = _loaded_after(code)
    assert "gppvae_tpu_torch" in loaded and not loaded & FORBIDDEN


@pytest.mark.parametrize("config", [c["name"] for c in DOC["configs"]])
def test_each_configurations_reference_imports_nothing_of_the_program(config):
    """Wherever the configuration's `reference` path lies."""
    cfg = Manifest().config(config)
    path = ROOT / cfg["reference"]
    assert path.resolve() == Path(cfg["reference_module"].__file__).resolve()
    assert not _top_level_imports(path) & (FORBIDDEN | {"gppvae_tpu_torch"}), path


def test_the_reference_loads_nothing_of_the_program():
    """Every configuration's reference module, loaded as a run loads it, with
    the rest of what the comparison uses."""
    code = ("from benchmark.harness.manifest import Manifest; m = Manifest(); "
            "[m.config(c['name']) for c in m.doc['configs']]; "
            "import benchmark.yardstick.flops, "
            "benchmark.yardstick.kernel_cost, benchmark.yardstick.peaks, "
            "benchmark.harness.checks, benchmark.harness.datagen, benchmark.harness.weights, "
            "benchmark.harness.traffic")
    loaded = _loaded_after(code)
    assert not loaded & (FORBIDDEN | {"gppvae_tpu_torch"})


def test_the_forbidden_check_compares_whole_names(monkeypatch):
    from benchmark import run

    monkeypatch.setitem(sys.modules, "gppvae_tpu_torch_lookalike", sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "gppvae_tpu.sub", sys)
    assert run.forbidden_modules() == ["gppvae_tpu"]
