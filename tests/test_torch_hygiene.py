"""The PyTorch port stands alone: it imports neither JAX nor the JAX package,
its entry points refuse to fall back to the CPU, and its kernel wrappers take
the plain path only for CPU tensors."""
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import NvmCsd, filter_count
from repro_torch.kernels.zone_filter import kernel as zf_kernel
from repro_torch.kernels.zone_filter.ref import filtered_reduce_ref
from repro_torch.zns import ZonedDevice

ROOT = Path(__file__).resolve().parents[1]
MODULES = ["repro_torch", "repro_torch.core", "repro_torch.zns",
           "repro_torch.kernels.zone_filter", "repro_torch.kernels.paged_attn",
           "repro_torch.serve", "repro_torch.array", "repro_torch.telemetry",
           "repro_torch.data", "repro_torch.train", "repro_torch.faults.crash",
           "repro_torch.models", "repro_torch.configs", "repro_torch.serve.step",
           "repro_torch.train.optimizer", "repro_torch.train.step",
           "repro_torch.train.trainer", "repro_torch.launch.train",
           "repro_torch.sharding", "repro_torch.sharding.rules",
           "repro_torch.sharding.pipeline", "repro_torch.launch.mesh"]


def test_port_import_leaves_jax_and_repro_out():
    code = (
        "import importlib, json, sys\n"
        f"for m in {MODULES!r}: importlib.import_module(m)\n"
        "print(json.dumps(sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_port_sources_import_no_jax_or_repro():
    pattern = re.compile(r"^\s*(import jax|from jax|import repro\b(?!_torch)|"
                         r"from repro\.|from repro import)", re.M)
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 24
    assert ROOT / "src" / "repro_torch" / "serve" / "kv_zones.py" in files
    for new in ("sharding/__init__.py", "sharding/rules.py", "sharding/pipeline.py",
                "launch/mesh.py"):
        assert ROOT / "src" / "repro_torch" / new in files
    offenders = [str(f.relative_to(ROOT)) for f in files
                 if pattern.search(f.read_text())]
    assert offenders == []


def test_nvmcsd_without_device_raises_when_cuda_is_absent(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    dev = ZonedDevice(num_zones=1, zone_bytes=64 * 1024, block_bytes=4096)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        NvmCsd(dev)
    assert NvmCsd(dev, device="cpu").torch_device == torch.device("cpu")


def test_filtered_reduce_on_cpu_takes_the_plain_path():
    pages = torch.from_numpy(np.random.default_rng(0).integers(
        -1000, 1000, (4, 256), dtype=np.int32))
    before = (zf_kernel.filtered_reduce.launches,
              zf_kernel.filtered_reduce_batched.launches)
    for kind in ("count", "sum", "min", "max"):
        got = zf_kernel.filtered_reduce(pages, kind=kind)
        assert torch.equal(got, filtered_reduce_ref(pages, kind))
    batched = zf_kernel.filtered_reduce_batched(pages.reshape(2, 2, 256))
    assert batched.tolist() == [512, 512]
    assert (zf_kernel.filtered_reduce.launches,
            zf_kernel.filtered_reduce_batched.launches) == before


def test_kernel_wrapper_rejects_unknown_kind():
    with pytest.raises(ValueError, match="kind"):
        zf_kernel.filtered_reduce(torch.zeros(2, 4, dtype=torch.int32),
                                  kind="mean")


def test_program_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from repro_torch.core.vm import jit_program
    from repro_torch.kernels.zone_filter.ops import kernel_program
    prog = filter_count("int32", "gt", 0)
    for build in (jit_program, kernel_program):
        with pytest.raises(RuntimeError, match="cuda"):
            build(prog, 4, 1024)


def test_pipeline_and_checkpoint_store_raise_when_cuda_is_absent(monkeypatch, tmp_path):
    from repro_torch.data import ZoneDataPipeline, ZoneDataStore
    from repro_torch.train import ZonedCheckpointStore, tree_from_numpy
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    store = ZoneDataStore(ZonedDevice(num_zones=1, zone_bytes=64 * 1024,
                                      block_bytes=4096), seq_len=31)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ZoneDataPipeline(store, batch=2)
    assert ZoneDataPipeline(store, batch=2, device="cpu").csd.torch_device.type == "cpu"
    dev = ZonedDevice(num_zones=2, zone_bytes=64 * 1024, block_bytes=4096)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ZonedCheckpointStore(device=dev)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ZonedCheckpointStore.striped(tmp_path, num_devices=2, num_zones=2,
                                     member_zone_bytes=64 * 1024, stripe_blocks=4)
    cpu_store = ZonedCheckpointStore(device=dev, torch_device="cpu")
    cpu_store.save(1, {"w": torch.zeros(4)})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cpu_store.restore(like={"w": torch.zeros(4)}, torch_device="cuda")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tree_from_numpy({"w": np.zeros(4)})
