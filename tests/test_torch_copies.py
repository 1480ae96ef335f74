"""Every module the port copies from the JAX package stays a copy.

These modules import no JAX, so the port keeps its own copy of each, with
every ``repro.`` rewritten to ``repro_torch.``. The reference's tests of
them import only ``repro``, so without this test the two could drift apart
unnoticed. A package ``__init__`` may differ in its docstring, which says
what the port holds so far; its code may not.
"""
import ast
from pathlib import Path

import pytest

SRC = Path(__file__).resolve().parents[1] / "src"
COPIED = [
    "zns/device.py", "zns/ring.py",
    "faults/errors.py", "faults/injector.py", "faults/retry.py",
    "telemetry/events.py", "telemetry/metrics.py", "telemetry/trace.py",
    "telemetry/health.py", "telemetry/alerts.py",
    "core/programs.py", "core/verifier.py", "core/cache.py", "core/prefetch.py",
    "array/queues.py", "array/striping.py", "array/rebuild.py",
    "models/config.py", "configs/__init__.py",
    *(f"configs/{p.name}" for p in sorted((SRC / "repro" / "configs").glob("*.py"))
      if p.name != "__init__.py"),
]
PACKAGES = ["zns/__init__.py", "faults/__init__.py", "telemetry/__init__.py",
            "array/__init__.py", "models/__init__.py"]


def reference(path):
    return (SRC / "repro" / path).read_text().replace("repro.", "repro_torch.")


@pytest.mark.parametrize("path", COPIED)
def test_copied_module_equals_its_reference(path):
    assert (SRC / "repro_torch" / path).read_text() == reference(path)


def _code(source):
    tree = ast.parse(source)
    body = tree.body
    if body and isinstance(body[0], ast.Expr) and isinstance(body[0].value, ast.Constant):
        body = body[1:]
    return ast.dump(ast.Module(body=body, type_ignores=[]))


@pytest.mark.parametrize("path", PACKAGES)
def test_copied_package_differs_only_in_its_docstring(path):
    assert _code((SRC / "repro_torch" / path).read_text()) == _code(reference(path))
