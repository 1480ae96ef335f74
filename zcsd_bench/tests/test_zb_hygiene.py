"""Nothing of the benchmark imports JAX or the JAX package; the references
import nothing but NumPy and PyTorch: never the program under test
(``repro_torch``), JAX or the JAX package, so that what judges the program
is independent of it."""
import ast
import sys

import pytest

from zcsd_bench import harness, spec

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
REFERENCE_IMPORTS = {"numpy", "torch", "__future__"}
SOURCES = sorted(p for p in spec.HERE.rglob("*.py") if "__pycache__" not in p.parts)


def top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(spec.HERE)))
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not top_level_imports(path) & FORBIDDEN


def reference_imports_allowed(path) -> bool:
    return top_level_imports(path) <= REFERENCE_IMPORTS


@pytest.mark.parametrize("path", sorted((spec.HERE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_a_reference_imports_numpy_alone(path):
    assert reference_imports_allowed(path)


@pytest.mark.parametrize("line", ["import repro_torch",
                                  "from repro_torch.kernels.paged_attn import ref",
                                  "import jax.numpy as jnp",
                                  "from repro.core import csd"])
def test_a_reference_importing_the_program_or_jax_is_refused(tmp_path, line):
    path = tmp_path / "plain.py"
    path.write_text(f"import numpy as np\nimport torch\n\n\ndef answers():\n    {line}\n")
    assert not reference_imports_allowed(path)
    path.write_text("import numpy as np\nimport torch\n")
    assert reference_imports_allowed(path)


def test_names_are_compared_whole():
    from zcsd_bench.run import forbidden_modules
    assert forbidden_modules(["repro_torch", "repro_torch.core", "jaxtyping",
                              "numpy"]) == []
    assert forbidden_modules(["repro.core.csd", "jaxlib.xla_client", "flax",
                              "jax"]) == ["flax", "jax", "jaxlib", "repro"]


def test_a_run_loads_neither_jax_nor_the_jax_package(cell):
    from zcsd_bench.run import forbidden_modules
    before = {m.split(".")[0] for m in sys.modules}
    harness.run_cell(cell("fig2-nvm.scan"), 5, 0.2, False, device="cpu")
    after = {m.split(".")[0] for m in sys.modules}
    assert "repro_torch" in after
    assert not (after - before) & FORBIDDEN
    assert set(forbidden_modules()) <= before
