"""Pipeline parallelism on gloo CPU ranks: the GPipe schedule equals
sequential stage application (``tests/test_pipeline.py``'s cases on the
port, at its 1e-5).

One spawn of 8 ranks (``test_torch_sharding.Ranks``) runs every case: a
``("pipe",)`` mesh of the first S ranks for (stages, micro-batches) = (4, 8),
(8, 16), (2, 3) and (1, 4) (one stage: no point-to-point call), and a
(pipe=4, data=2) mesh whose two data columns each run the pipeline. Every
rank of a mesh returns the whole output, and each one's is checked. Also
the rank harness itself: a rank that raises fails the run with its error,
and one that hangs is killed at the wall-clock limit.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from test_torch_sharding import Ranks

CASES = [(4, 8), (8, 16), (2, 3), (1, 4)]


def stage_fn(p, x):
    return torch.tanh(x @ p["w"] + p["b"])


def make(n_stages, n_micro, mb=2, d=16, seed=0):
    rng = np.random.default_rng(seed)
    params = {
        "w": torch.from_numpy((rng.standard_normal((n_stages, d, d)) * 0.5).astype(np.float32)),
        "b": torch.from_numpy((rng.standard_normal((n_stages, d)) * 0.1).astype(np.float32)),
    }
    xs = torch.from_numpy(rng.standard_normal((n_micro, mb, d)).astype(np.float32))
    return params, xs


def sequential(params, xs, n_stages):
    out = xs
    for s in range(n_stages):
        p = {k: a[s] for k, a in params.items()}
        out = torch.stack([stage_fn(p, out[i]) for i in range(out.shape[0])])
    return out


def _pipeline_cases(rank: int, world: int, workdir: str) -> dict:
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch.sharding.pipeline import pipeline_apply

    runs = [((s,), ("pipe",), make(s, m, seed=s)) for s, m in CASES]
    runs.append(((4, 2), ("pipe", "data"), make(4, 8, mb=4, seed=9)))
    out = {}
    for shape, names, (params, xs) in runs:
        n = int(np.prod(shape))
        mesh = DeviceMesh("cpu", torch.arange(n).reshape(shape), mesh_dim_names=names)
        got = pipeline_apply(stage_fn, params, xs, mesh=mesh) if rank < n else None
        every = [None] * world
        dist.all_gather_object(every, got)
        out[shape] = [g for g in every if g is not None]
    return out


@pytest.fixture(scope="module")
def pipelined(tmp_path_factory):
    return Ranks(_pipeline_cases, 8, tmp_path_factory.mktemp("pipeline")).result()


@pytest.mark.parametrize("n_stages,n_micro", CASES)
def test_pipeline_matches_sequential(pipelined, n_stages, n_micro):
    params, xs = make(n_stages, n_micro, seed=n_stages)
    want = sequential(params, xs, n_stages)
    got = pipelined[(n_stages,)]
    assert len(got) == n_stages
    for g in got:
        np.testing.assert_allclose(g.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)


def test_pipeline_composes_with_data_axis(pipelined):
    """(pipe=4, data=2) mesh: pipeline inside, batch untouched."""
    params, xs = make(4, 8, mb=4, seed=9)
    want = sequential(params, xs, 4)
    got = pipelined[(4, 2)]
    assert len(got) == 8
    for g in got:
        np.testing.assert_allclose(g.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)


def _fails(rank: int, world: int, workdir: str) -> None:
    import time
    if rank == 1:
        raise ValueError("rank 1 fails on purpose")
    time.sleep(600)                      # rank 0 is still busy when rank 1 fails


def _hangs(rank: int, world: int, workdir: str) -> None:
    import time
    if rank == 1:
        time.sleep(600)


def test_a_failing_rank_fails_the_run_with_its_error(tmp_path):
    import torch.multiprocessing as mp
    ranks = Ranks(_fails, 2, tmp_path)
    with pytest.raises(mp.ProcessRaisedException, match="rank 1 fails on purpose"):
        ranks.result()
    assert not any(p.is_alive() for p in ranks.ctx.processes)


def test_a_hung_rank_is_killed_at_the_wall_clock_limit(tmp_path):
    ranks = Ranks(_hangs, 2, tmp_path, limit_s=10)
    with pytest.raises(TimeoutError):
        ranks.result()
    assert not any(p.is_alive() for p in ranks.ctx.processes)


def test_bubble_fraction():
    from repro_torch.sharding.pipeline import bubble_fraction
    assert bubble_fraction(4, 12) == pytest.approx(3 / 15)
    assert bubble_fraction(1, 8) == 0.0
