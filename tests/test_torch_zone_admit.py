"""The zone-admission kernel's wrapper (``kernels/zone_admit``) on the CPU:
``plan``, which checks what the kernel takes and cuts an admission into
launches of up to 64 zones, the plain version the CPU takes, and
``KVZoneCache.admit`` going to it. The kernel itself runs in
``tests/test_torch_zone_admit_card.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.zone_admit import kernel
from repro_torch.kernels.zone_admit.ref import zone_admit_ref
from repro_torch.serve import KVZoneCache

L, NZ, ZL, KV, HD = 3, 200, 4, 2, 8
SENTINEL = -7.0


def pools(dtype=torch.float32, shape=(L, NZ, ZL, KV, HD)):
    return torch.full(shape, SENTINEL, dtype=dtype), torch.full(shape, SENTINEL, dtype=dtype)


def source(n, dtype=torch.float32, seed=0, kv=KV, hd=HD):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(L, n, kv, hd, generator=g).to(dtype),
            torch.randn(L, n, kv, hd, generator=g).to(dtype))


def zones_for(n, start=5):
    return [start + 2 * r for r in range(-(-n // ZL))]


@pytest.mark.parametrize("n", [1, ZL, ZL + 1, 3 * ZL - 1])
def test_the_plain_version_fills_each_run_and_keeps_the_last_zone_s_other_slots(n):
    kp, vp = pools()
    k, v = source(n)
    zones = zones_for(n)
    kernel.zone_admit(kp, vp, k, v, zones)
    for pool, src in ((kp, k), (vp, v)):
        for r, z in enumerate(zones):
            run = min(n - r * ZL, ZL)
            assert torch.equal(pool[:, z, :run], src[:, r * ZL:r * ZL + run])
            assert (pool[:, z, run:] == SENTINEL).all()
        untouched = [z for z in range(NZ) if z not in zones]
        assert (pool[:, untouched] == SENTINEL).all()


def test_a_cpu_cache_s_admit_takes_the_plain_version(monkeypatch):
    calls = []

    def plain(*args):
        calls.append(list(args[4]))
        return zone_admit_ref(*args)

    def no_build():
        raise AssertionError("a cache on the CPU built the kernel")
    monkeypatch.setattr(kernel, "zone_admit_ref", plain)
    monkeypatch.setattr(kernel, "load", no_build)
    before = kernel.zone_admit.launches
    c = KVZoneCache(num_layers=L, num_zones=10, zone_len=ZL, kv_heads=KV, head_dim=HD,
                    max_zones_per_seq=4, dtype=torch.bfloat16, device="cpu")
    k, v = source(2 * ZL + 1)                     # float32 into a bfloat16 cache
    c.admit(7, k, v)
    assert calls == [c._seqs[7].zones] == [[0, 1, 2]]
    assert kernel.zone_admit.launches == before
    assert torch.equal(c.k[:, 0], k[:, :ZL].to(torch.bfloat16))
    assert torch.equal(c.v[:, 2, :1], v[:, 2 * ZL:].to(torch.bfloat16))


@pytest.mark.parametrize("runs,cut", [(0, []), (1, [1]), (64, [64]), (65, [64, 1]),
                                      (130, [64, 64, 2])])
def test_plan_cuts_an_admission_into_launches_of_64_zones(runs, cut):
    n = max(runs * ZL - 1, 0)
    kp, vp = pools()
    k, v = source(n)
    zones = list(range(NZ - 1, NZ - 1 - runs, -1))
    p = kernel.plan(kp, vp, k, v, zones)
    assert [len(ids) for _, _, ids in p.launches] == cut
    assert [first for first, _, _ in p.launches] == [64 * ZL * i for i in range(len(cut))]
    assert sum(m for _, m, _ in p.launches) == n
    assert [z for _, _, ids in p.launches for z in ids] == zones


def test_plan_reads_a_prefill_row_in_16_byte_units_with_its_own_strides():
    kp, vp = pools(torch.bfloat16, (L, 6, 16, 8, 128))
    rows = torch.zeros(L, 3, 40, 8, 128, dtype=torch.bfloat16)    # [L, B, n, KV, hd]
    k, v = rows[:, 1], rows[:, 2].clone()
    p = kernel.plan(kp, vp, k, v, [4, 0, 5])
    row = 8 * 128 * 2
    assert (p.unit, p.row_units, p.zone_len) == (16, row // 16, 16)
    assert p.src_layer == (3 * 40 * row, 40 * row) and p.src_token == (row, row)
    assert (p.dst_layer, p.dst_zone) == (6 * 16 * row, 16 * row)
    assert p.launches == ((0, 40, (4, 0, 5)),)


@pytest.mark.parametrize("what,unit", [("row of 12 bytes", 4), ("odd start", 2),
                                       ("strided tokens", 8)])
def test_plan_takes_smaller_units_where_16_bytes_do_not_divide(what, unit):
    if what == "row of 12 bytes":
        kp, vp = pools(torch.float32, (L, 4, ZL, 1, 3))
        k, v = source(ZL, kv=1, hd=3)
    elif what == "odd start":
        kp, vp = pools(torch.bfloat16)
        flat = torch.zeros(L * ZL * KV * HD + 1, dtype=torch.bfloat16)
        k = flat[1:].view(L, ZL, KV, HD)
        v = k.clone()
    else:
        kp, vp = pools(torch.float32, (L, 4, ZL, 1, 2))
        k = torch.zeros(L, ZL, 3, 2)[:, :, :1]               # a token every 24 bytes
        v = k.clone()
    assert kernel.plan(kp, vp, k, v, [1]).unit == unit


def _bad(case):
    kp, vp = pools()
    k, v = source(ZL + 1)
    zones = [3, 4]
    if case == "rank":
        k, v = k[0], v[0]
    elif case == "k and v differ":
        v = v[:, :ZL]
    elif case == "layers":
        k, v = k[:2], v[:2]
    elif case == "row shape":
        k, v = k[..., :HD // 2], v[..., :HD // 2]
    elif case == "pool rank":
        kp, vp = kp[0], vp[0]
    elif case == "zone count":
        zones = [3]
    elif case == "zone out of range":
        zones = [3, NZ]
    elif case == "zone twice":
        zones = [3, 3]
    elif case == "dtype":
        k, v = k.to(torch.bfloat16), v.to(torch.bfloat16)
    elif case == "mixed devices":
        k = torch.empty(k.shape, device="meta")
    elif case == "rows not dense":
        k = torch.zeros(L, ZL + 1, HD, KV).transpose(2, 3)
    elif case == "pool not contiguous":
        kp = torch.zeros(L, NZ, ZL, HD, KV).transpose(3, 4)
    return kp, vp, k, v, zones


SHAPE_CASES = ["rank", "k and v differ", "layers", "row shape", "pool rank", "zone count",
               "zone out of range", "zone twice"]
KERNEL_CASES = ["dtype", "mixed devices", "rows not dense", "pool not contiguous"]


@pytest.mark.parametrize("case", SHAPE_CASES + KERNEL_CASES)
def test_plan_refuses_what_the_kernel_does_not_take(case):
    with pytest.raises((ValueError, TypeError), match="zone_admit"):
        kernel.plan(*_bad(case))


@pytest.mark.parametrize("case", SHAPE_CASES)
def test_the_wrapper_refuses_a_bad_shape_on_the_cpu_too(case):
    kp, vp, k, v, zones = _bad(case)
    before = (kp.clone(), vp.clone())
    with pytest.raises(ValueError, match="zone_admit"):
        kernel.zone_admit(kp, vp, k, v, zones)
    assert torch.equal(kp, before[0]) and torch.equal(vp, before[1])


def test_the_wrapper_refuses_a_device_it_has_no_path_for():
    kp, vp = (torch.empty(L, NZ, ZL, KV, HD, device="meta") for _ in range(2))
    k, v = (torch.empty(L, 1, KV, HD, device="meta") for _ in range(2))
    with pytest.raises(ValueError, match="unsupported device"):
        kernel.zone_admit(kp, vp, k, v, [0])


@pytest.mark.parametrize("layout,dense", [("contiguous", True), ("rows transposed", False),
                                           ("one KV head", True), ("head width 1", True),
                                           ("strided tokens", True)])
def test_rows_dense(layout, dense):
    t = {"contiguous": torch.zeros(2, 3, 4, 5),
         "rows transposed": torch.zeros(2, 3, 5, 4).transpose(2, 3),
         "one KV head": torch.zeros(2, 3, 1, 5),
         "head width 1": torch.zeros(2, 3, 4, 1),
         "strided tokens": torch.zeros(2, 6, 4, 5)[:, ::2]}[layout]
    assert kernel.rows_dense(t) is dense


def test_a_source_in_another_dtype_is_cast_once_before_the_launch():
    from repro_torch.serve.kv_zones import _admit_source
    pool = torch.zeros(L, 2, ZL, KV, HD, dtype=torch.bfloat16)
    k, _ = source(3)
    got = _admit_source(k, pool)
    assert got.dtype == torch.bfloat16 and torch.equal(got, k.to(torch.bfloat16))
    same = k.to(torch.bfloat16)
    assert _admit_source(same, pool) is same
    permuted = torch.zeros(L, 3, HD, KV, dtype=torch.bfloat16).transpose(2, 3)
    assert kernel.rows_dense(_admit_source(permuted, pool))
    assert np.array_equal(_admit_source(permuted, pool).float().numpy(),
                          permuted.float().numpy())
