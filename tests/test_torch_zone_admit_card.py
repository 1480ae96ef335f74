"""The zone-admission kernel (``kernels/zone_admit/csrc/zone_admit.cu``) on
the card against its plain version (``ref.py``, one ``copy_`` of K and one
of V a zone run) run on the card, bit for bit, in bfloat16 and float32: a
row of a prefill cache, contiguous, token-strided and misaligned sources of
1, ZL, ZL + 1 and 3,584 tokens at granite-8b's KV x hd; zones at the far
end of a pool of more than 2^31 elements; a partial last zone whose other
slots keep a sentinel; one launch an admission of up to 64 zones; a card
``KVZoneCache`` against one on the CPU; and the kernel's time for a
2,400-token granite prompt against its bytes bound.

Run on the card with ``PYTHONPATH=src python -m pytest -q -m cuda
tests/test_torch_zone_admit_card.py``; without a Hopper card every test
skips (the kernel has no CPU mode). No JAX in this file.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.zone_admit import kernel as za
from repro_torch.kernels.zone_admit.ref import zone_admit_ref
from repro_torch.serve import KVZoneCache
from zcsd_bench.bound import HBM_BYTES_PER_S

KV, HD, ZL = 8, 128, 128                 # granite-8b's KV heads, head width; the cell's zones
DTYPES = [torch.bfloat16, torch.float32]
SENTINEL = -3.0
_BITS = {torch.bfloat16: torch.int16, torch.float32: torch.int32}


def card():
    if not torch.cuda.is_available() or torch.cuda.get_device_capability() < (9, 0):
        pytest.skip("needs a Hopper card: the zone-admission kernel has no CPU mode")


def randn(*shape, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn(shape, generator=g, device="cuda").to(dtype)


def pools(shape, dtype):
    return (torch.full(shape, SENTINEL, dtype=dtype, device="cuda"),
            torch.full(shape, SENTINEL, dtype=dtype, device="cuda"))


def bit_equal(a, b):
    return torch.equal(a.view(_BITS[a.dtype]), b.view(_BITS[b.dtype]))


def admitted(k, v, shape, zones):
    """The pools after the kernel's admission and after the plain
    version's, from the same sentinel; asserts one launch an admission of
    up to 64 zones."""
    kp, vp = pools(shape, k.dtype)
    kr, vr = pools(shape, k.dtype)
    before = za.zone_admit.launches
    za.zone_admit(kp, vp, k, v, zones)
    torch.cuda.synchronize()
    assert za.zone_admit.launches - before == -(-len(zones) // za.MAX_ZONES)
    zone_admit_ref(kr, vr, k, v, zones)
    return kp, vp, kr, vr


def sources(kind, L, n, dtype, seed):
    """K and V ``[L, n, KV, hd]`` of a layout: a row of a ``[L, B, n, KV,
    hd]`` prefill cache, contiguous, a token every two rows, or starting
    one value past a 16-byte boundary (so the kernel copies in value-sized
    units)."""
    if kind == "prefill_row":
        rows = randn(L, 3, n, KV, HD, dtype=dtype, seed=seed)
        return rows[:, 1], rows[:, 2]
    if kind == "contiguous":
        return randn(L, n, KV, HD, dtype=dtype, seed=seed), randn(L, n, KV, HD, dtype=dtype,
                                                                    seed=seed + 1)
    if kind == "strided_tokens":
        both = randn(L, n, 2, KV, HD, dtype=dtype, seed=seed)
        return both[:, :, 0], both[:, :, 1]
    flat = randn(2 * L * n * KV * HD + 1, dtype=dtype, seed=seed)
    return (flat[1:1 + L * n * KV * HD].view(L, n, KV, HD),
            flat[1 + L * n * KV * HD:].view(L, n, KV, HD))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("kind", ["prefill_row", "contiguous", "strided_tokens", "misaligned"])
@pytest.mark.parametrize("n", [1, ZL, ZL + 1, 3584])
def test_the_kernel_leaves_the_plain_copy_s_pool_bit_for_bit(dtype, kind, n, record_property):
    card()
    L, NZ = 4, 40
    k, v = sources(kind, L, n, dtype, seed=n)
    zones = np.random.default_rng(n).permutation(NZ)[:-(-n // ZL)].tolist()
    unit = za.plan(*pools((L, NZ, ZL, KV, HD), dtype), k, v, zones).unit
    assert unit == (k.element_size() if kind == "misaligned" else 16)
    kp, vp, kr, vr = admitted(k, v, (L, NZ, ZL, KV, HD), zones)
    record_property("max_abs_err.zone_admit",
                    max(float((kp.float() - kr.float()).abs().max()),
                        float((vp.float() - vr.float()).abs().max())))
    assert bit_equal(kp, kr) and bit_equal(vp, vr)
    last = n - (len(zones) - 1) * ZL
    assert (kp[:, zones[-1], last:] == SENTINEL).all()          # the partial zone's rest
    assert bit_equal(kp[:, zones[-1], :last], k[:, n - last:])


@pytest.mark.cuda
def test_zones_at_the_far_end_of_a_pool_past_2_31_elements():
    """4 layers of 4,200 zones of 128 x 8 x 128 bf16: 2.2e9 elements a
    pool, so layer 3's last zones lie past 2^31 elements (4.4 GB a pool)."""
    card()
    L, NZ, n = 4, 4200, 2 * ZL + 44
    assert L * NZ * ZL * KV * HD > 2**31
    kp, vp = pools((L, NZ, ZL, KV, HD), torch.bfloat16)
    k, v = sources("prefill_row", L, n, torch.bfloat16, seed=5)
    zones = [NZ - 1, NZ - 3, NZ - 2]
    before = za.zone_admit.launches
    za.zone_admit(kp, vp, k, v, zones)
    torch.cuda.synchronize()
    assert za.zone_admit.launches == before + 1
    for pool, src in ((kp, k), (vp, v)):
        for r, z in enumerate(zones):
            run = min(ZL, n - r * ZL)
            assert bit_equal(pool[:, z, :run], src[:, r * ZL:r * ZL + run])
        assert (pool[:, NZ - 2, 44:] == SENTINEL).all()
        assert (pool[:, :NZ - 3] == SENTINEL).all()
    del kp, vp
    torch.cuda.empty_cache()


@pytest.mark.cuda
@pytest.mark.parametrize("runs", [1, 63, 64, 65, 130])
def test_one_launch_an_admission_of_up_to_64_zones(runs):
    card()
    zl, L, NZ = 4, 3, 140
    n = runs * zl - 1
    k, v = randn(L, n, KV, HD, dtype=torch.bfloat16, seed=runs), \
        randn(L, n, KV, HD, dtype=torch.bfloat16, seed=runs + 1)
    zones = np.random.default_rng(runs).permutation(NZ)[:runs].tolist()
    kp, vp, kr, vr = admitted(k, v, (L, NZ, zl, KV, HD), zones)   # counts the launches
    assert bit_equal(kp, kr) and bit_equal(vp, vr)


@pytest.mark.cuda
def test_a_card_cache_admits_what_a_cpu_cache_admits():
    """The same admissions and evictions into a ``KVZoneCache`` on the card
    and one on the CPU (the plain version): the same bytes, zones and
    counters; one launch an admission; float32 sources into a bfloat16
    cache are cast, and a source on the CPU is moved, once."""
    card()
    L, NZ = 3, 24
    args = dict(num_layers=L, num_zones=NZ, zone_len=16, kv_heads=KV, head_dim=HD,
                max_zones_per_seq=8, dtype=torch.bfloat16)
    dev, cpu = KVZoneCache(device="cuda", **args), KVZoneCache(device="cpu", **args)
    before = za.zone_admit.launches
    admissions = 0
    for sid, n, where in ((0, 40, "cuda"), (1, 16, "cpu"), (2, 1, "cuda"), (3, 100, "cuda")):
        rows = randn(L, 2, n, KV, HD, dtype=torch.float32, seed=sid)
        k, v = rows[:, 0], rows[:, 1]
        if where == "cpu":
            k, v = k.cpu(), v.cpu()
        dev.admit(sid, k, v)
        cpu.admit(sid, k.cpu(), v.cpu())
        admissions += 1
        if sid == 1:
            dev.evict(0)
            cpu.evict(0)
    torch.cuda.synchronize()
    assert za.zone_admit.launches - before == admissions
    assert torch.equal(dev.k.cpu(), cpu.k) and torch.equal(dev.v.cpu(), cpu.v)
    assert dev._free == cpu._free
    assert {s: (st.zones, st.length) for s, st in dev._seqs.items()} == \
        {s: (st.zones, st.length) for s, st in cpu._seqs.items()}
    assert dict(dev.stats) == dict(cpu.stats)


def _events_ms(fn, reps=20):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


@pytest.mark.cuda
def test_a_granite_prompt_s_admission_near_its_bytes_bound(record_property):
    """A 2,400-token prompt of granite-8b (36 layers, bf16), a row of its
    prefill cache, into 19 zones: 354 MB of K and V read and written once,
    0.21 ms at 3.35 TB/s. CUDA events around 20 admissions, the kernel's
    and the plain version's (one copy_ of K and one of V a zone run)."""
    card()
    L, NZ, n = 36, 40, 2400
    k, v = sources("prefill_row", L, n, torch.bfloat16, seed=24)
    zones = np.random.default_rng(24).permutation(NZ)[:-(-n // ZL)].tolist()
    kp, vp = pools((L, NZ, ZL, KV, HD), torch.bfloat16)
    before = za.zone_admit.launches
    ms = _events_ms(lambda: za.zone_admit(kp, vp, k, v, zones))
    assert za.zone_admit.launches - before == 21
    kr, vr = pools((L, NZ, ZL, KV, HD), torch.bfloat16)
    plain_ms = _events_ms(lambda: zone_admit_ref(kr, vr, k, v, zones))
    assert bit_equal(kp, kr) and bit_equal(vp, vr)
    moved = 2 * 2 * L * n * KV * HD * 2          # K and V, read and written, 2 bytes a value
    bound_ms = moved / HBM_BYTES_PER_S * 1e3
    record_property("ms.zone_admit", ms)
    record_property("plain_ms.zone_admit", plain_ms)
    record_property("bound_ms.zone_admit", bound_ms)
    record_property("share_of_bound.zone_admit", bound_ms / ms)
    assert ms < plain_ms
