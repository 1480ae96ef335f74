"""The power-loss crash harness on the port.

The four ``TestCrashHarness`` cases of ``tests/test_faults.py`` run as they
are written against ``repro_torch.faults.crash`` and the port's checkpoint
store (every ``from repro.`` import naming ``repro_torch.``; the harness and
the store restoring onto ``torch_device="cpu"``). Then a sweep over torch
leaves (bfloat16 and a None node included), whose journal of member appends
must equal the reference's over the same bits: the two stores write the
same zones in the same order. Every restore is checked bit for bit.
"""
import ast
import dataclasses
import functools
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.faults.crash import PowerLossHarness as RefHarness
from repro_torch.faults.crash import PowerLossHarness, _trees_equal
from repro_torch.train import ZonedCheckpointStore as _PortStore
from repro_torch.train import tree_from_numpy

_REFERENCE = Path(__file__).with_name("test_faults.py")
_STORE_IMPORT = "        from repro.train.checkpoint import ZonedCheckpointStore\n"


def _crash_cases():
    """``test_faults.py``'s imports and its TestCrashHarness class, against
    the port, at their own lines; the class's import of the store is
    blanked so that the module's CPU-bound store below is the one it uses."""
    source = _REFERENCE.read_text()
    assert _STORE_IMPORT in source
    tree = ast.parse(source.replace(_STORE_IMPORT, "\n")
                     .replace("from repro.", "from repro_torch."))
    body = [n for n in tree.body if isinstance(n, (ast.Import, ast.ImportFrom))
            or (isinstance(n, ast.ClassDef) and n.name == "TestCrashHarness")]
    return compile(ast.Module(body=body, type_ignores=[]), str(_REFERENCE), "exec")


exec(_crash_cases())
PowerLossHarness = functools.partial(PowerLossHarness, torch_device="cpu")  # noqa: F811
ZonedCheckpointStore = types.SimpleNamespace(
    striped=functools.partial(_PortStore.striped, torch_device="cpu"))

SWEEP = dict(num_devices=4, num_zones=6, member_zone_bytes=256 * 1024,
             stripe_blocks=4, redundancy="raid1")


def numpy_steps():
    rng = np.random.default_rng(11)
    out = []
    for s in (1, 2):
        w = rng.standard_normal(300).astype(np.float32) + s
        out.append((s, {"w": w, "h": np.asarray(jnp.asarray(w[:40], jnp.bfloat16)),
                        "n": None, "b": np.full((17,), s, np.int32)}))
    return out


def test_torch_leaves_sweep_matches_reference_journal(tmp_path):
    """The same two saves, as numpy through the reference and as tensors
    through the port: identical journals, and every boundary recovers."""
    steps = numpy_steps()
    ref = RefHarness(tmp_path / "ref", **SWEEP)
    ref_out = ref.run(steps)
    port = PowerLossHarness(tmp_path / "port", **SWEEP)
    port_out = port.run([(s, tree_from_numpy(t, "cpu")) for s, t in steps])
    assert [dataclasses.astuple(e) for e in port.journal] == \
        [dataclasses.astuple(e) for e in ref.journal]
    assert [(o.boundary, o.recovered_step, o.lo, o.hi, o.refused, o.ok) for o in port_out] \
        == [(o.boundary, o.recovered_step, o.lo, o.hi, o.refused, o.ok) for o in ref_out]
    assert port.summary() == ref.summary() and port.summary()["all_ok"]


def test_trees_equal_is_bitwise():
    a = {"w": torch.tensor([0.0, 1.0]), "h": torch.ones(3, dtype=torch.bfloat16)}
    assert _trees_equal(a, {"h": np.asarray(jnp.ones(3, jnp.bfloat16)),
                            "w": np.array([0.0, 1.0], np.float32)})
    assert not _trees_equal(a, {"w": torch.tensor([-0.0, 1.0]), "h": a["h"]})
    assert not _trees_equal(a, {"w": a["w"], "h": a["h"].view(torch.int16)})
    assert not _trees_equal(a, {"w": a["w"]})


def test_harness_requires_cuda_unless_told_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from repro_torch.faults import crash
    with pytest.raises(RuntimeError, match="device='cpu'"):
        crash.PowerLossHarness(tmp_path)
    assert crash.PowerLossHarness(tmp_path, torch_device="cpu").torch_device.type == "cpu"
