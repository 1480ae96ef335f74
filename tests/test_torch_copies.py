"""Every module the port copies from the JAX package stays a copy.

These modules import no JAX, so the port keeps its own copy of each, with
every ``repro.`` rewritten to ``repro_torch.``. The reference's tests of
them import only ``repro``, so without this test the two could drift apart
unnoticed. A package ``__init__`` may differ in its docstring, which says
what the port holds so far; its code may not. A module the port extends
(``EXTENDED``) keeps every statement of the reference's as it is, but for
the functions it names, which keep the reference's parameters first; its
classes may only add members.
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
# the port's tracer adds the collector's events, the clock anchors and
# their export onto a profiler's axis, and ``tag`` on an open span
EXTENDED = {"telemetry/trace.py": {"__all__", "set_enabled", "tracing",
                                   "to_chrome_events", "export_chrome"}}
PACKAGES = ["zns/__init__.py", "faults/__init__.py", "telemetry/__init__.py",
            "array/__init__.py", "models/__init__.py"]


def reference(path):
    return (SRC / "repro" / path).read_text().replace("repro.", "repro_torch.")


@pytest.mark.parametrize("path", COPIED)
def test_copied_module_equals_its_reference(path):
    port = (SRC / "repro_torch" / path).read_text()
    if path not in EXTENDED:
        assert port == reference(path)
        return
    _keeps(ast.parse(port).body, ast.parse(reference(path)).body, EXTENDED[path])


def _is_docstring(node):
    return isinstance(node, ast.Expr) and isinstance(node.value, ast.Constant) \
        and isinstance(node.value.value, str)


def _statements(body):
    """A body's statements by name (the code for an import or any other
    statement), docstrings left out."""
    out = {}
    for node in body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            out[node.name] = node
        elif isinstance(node, ast.Assign) and len(node.targets) == 1:
            out[ast.unparse(node.targets[0])] = node
        elif isinstance(node, ast.AnnAssign):
            out[ast.unparse(node.target)] = node
        elif not _is_docstring(node):
            out[ast.unparse(node)] = node
    return out


def _params(fn):
    return [a.arg for a in fn.args.posonlyargs + fn.args.args + fn.args.kwonlyargs]


def _keeps(port_body, ref_body, changed):
    port = _statements(port_body)
    for name, node in _statements(ref_body).items():
        assert name in port, f"{name} is gone from the port"
        got = port[name]
        if isinstance(node, ast.ClassDef):
            assert [ast.dump(b) for b in got.bases] == [ast.dump(b) for b in node.bases]
            _keeps(got.body, node.body, set())
        elif name not in changed:
            assert ast.dump(got) == ast.dump(node), f"{name} differs from the reference"
        elif isinstance(node, ast.Assign):          # a list the port extends
            assert set(ast.literal_eval(node.value)) <= set(ast.literal_eval(got.value))
        else:
            assert _params(got)[:len(_params(node))] == _params(node), name


def _code(source):
    tree = ast.parse(source)
    body = tree.body
    if body and isinstance(body[0], ast.Expr) and isinstance(body[0].value, ast.Constant):
        body = body[1:]
    return ast.dump(ast.Module(body=body, type_ignores=[]))


@pytest.mark.parametrize("path", PACKAGES)
def test_copied_package_differs_only_in_its_docstring(path):
    assert _code((SRC / "repro_torch" / path).read_text()) == _code(reference(path))
