"""The zone-filter kernel on the card: one launch a call, and float sums
that are the same bits on every path. Marked ``cuda``: skipped without an
NVIDIA Hopper card, since the CUDA kernel has no CPU mode. No JAX here, so
the file runs on the card's machine:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_zone_filter_card.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.zone_filter import kernel as zf_kernel
from repro_torch.kernels.zone_filter import ref as zf_ref

PAGE_ELEMS = 1024


@pytest.fixture
def card():
    if not torch.cuda.is_available() or torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("needs an NVIDIA Hopper card (sm_90a): the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _card_floats(n_pages, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy((rng.standard_normal((n_pages, PAGE_ELEMS)) * 100)
                            .astype(np.float32)).cuda()


@pytest.mark.cuda
def test_one_launch_a_call_on_the_card(card):
    """A single and a batched call each run one kernel on the card. The
    profiler's first step is a warm-up it drops; it can still miss kernels,
    never add them, so the fullest of three sessions is read."""
    from torch.profiler import ProfilerActivity, profile, schedule
    x = _card_floats(64, seed=1)
    calls = (lambda: zf_kernel.filtered_reduce(x, kind="sum"),
             lambda: zf_kernel.filtered_reduce_batched(x.reshape(4, 16, PAGE_ELEMS)))
    for call in calls:
        seen = []
        for _ in range(3):
            with profile(activities=[ProfilerActivity.CUDA],
                         schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
                for _ in range(2):
                    for _ in range(5):
                        call()
                    torch.cuda.synchronize()
                    prof.step()
            seen.append([(e.key, e.count) for e in prof.key_averages()
                         if getattr(e, "self_device_time_total", 0) > 0])
        fullest = max(seen, key=lambda kernels: sum(n for _, n in kernels))
        assert [n for _, n in fullest] == [5], seen


@pytest.mark.cuda
@pytest.mark.parametrize("n_pages", [64, 2048])
def test_float_sums_are_the_same_bits_on_every_path(card, n_pages):
    """A float sum gives the same bits alone, as a batched row, repeated
    (each launch leaves its tickets at 0) and on two streams at once, and
    is within rtol 1e-5 of the plain version's summed magnitudes."""
    x, other = _card_floats(n_pages, seed=2), _card_floats(n_pages, seed=3)
    single = zf_kernel.filtered_reduce(x, kind="sum")
    runs = [zf_kernel.filtered_reduce_batched(torch.stack([other, x]), kind="sum")[1]]
    runs += [zf_kernel.filtered_reduce(x, kind="sum") for _ in range(3)]
    s1, s2 = torch.cuda.Stream(), torch.cuda.Stream()
    y = x.clone()
    for s in (s1, s2):
        s.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(s):
            torch.cuda._sleep(1_000_000)
    for _ in range(4):
        for s, t in ((s1, x), (s2, y)):
            with torch.cuda.stream(s):
                runs.append(zf_kernel.filtered_reduce(t, kind="sum"))
    torch.cuda.synchronize()
    bits = single.reshape(1).view(torch.int32)
    assert all(torch.equal(r.reshape(1).view(torch.int32), bits) for r in runs)
    want = zf_ref.filtered_reduce_ref(x, "sum").double()
    assert abs(float(single) - float(want)) <= 1e-5 * float(x.double().abs().sum())


@pytest.mark.cuda
def test_grouped_batch_rows_are_the_same_bits_as_each_chunk(card):
    """At the array's dispatch shape, 512 chunks of 64 pages, a CUDA block
    runs 4 one-tile fold blocks (zone_filter.cu::launch groups them while
    the grid keeps 2,048 blocks); each row's float sum is still the same
    bits as its chunk run alone."""
    x = _card_floats(512 * 64, seed=4).reshape(512, 64, PAGE_ELEMS)
    rows = zf_kernel.filtered_reduce_batched(x, kind="sum")
    for i in (0, 1, 257, 511):
        single = zf_kernel.filtered_reduce(x[i], kind="sum")
        assert torch.equal(rows[i].reshape(1).view(torch.int32),
                           single.reshape(1).view(torch.int32)), i
