"""The port's zoned cache of every layer (``KVZoneCache``) against per-token
appends to one ``KVZonePool`` a layer, on the CPU.

A step's ``reserve`` and one ``write`` a layer, and a prompt's ``admit``,
must leave the bytes, zone tables, lengths, free list and counters that
``append`` and ``extend`` leave in the pools, through evictions and zone
reuse, and raise the errors appends raise (the pool exhausted, a sequence
past ``max_zones_per_seq``), changing nothing when they do.
"""
import numpy as np
import pytest
import torch

from repro_torch.serve import KVZoneCache, KVZoneError, KVZonePool

L, KV, HD, H = 3, 2, 8, 4


def cache(dtype=torch.float32, **kw):
    args = dict(num_layers=L, num_zones=10, zone_len=4, kv_heads=KV, head_dim=HD,
                max_zones_per_seq=4, dtype=dtype, device="cpu")
    args.update(kw)
    return KVZoneCache(**args)


def pools(dtype=torch.float32, **kw):
    args = dict(num_zones=10, zone_len=4, kv_heads=KV, head_dim=HD, max_zones_per_seq=4,
                dtype=dtype, device="cpu")
    args.update(kw)
    return [KVZonePool(**args) for _ in range(L)]


def kv(rng, *shape):
    return (torch.from_numpy(rng.standard_normal(shape).astype(np.float32)),
            torch.from_numpy(rng.standard_normal(shape).astype(np.float32)))


def admit_both(c, ps, sid, k, v):
    c.admit(sid, k, v)
    for layer, p in enumerate(ps):
        p.add_sequence(sid)
        p.extend(sid, k[layer], v[layer])


def step_both(c, ps, sids, rng):
    k, v = kv(rng, L, len(sids), KV, HD)
    step = c.reserve(sids)
    for layer, p in enumerate(ps):
        step.write(layer, k[layer].to(c.k.dtype), v[layer].to(c.k.dtype))
        for b, sid in enumerate(sids):
            p.append(sid, k[layer, b], v[layer, b])
    return step


def assert_same(c, ps, sids):
    for layer, p in enumerate(ps):
        assert torch.equal(c.k[layer], p.k) and torch.equal(c.v[layer], p.v)
        assert c._free == p._free
    tab, lengths = ps[0].zone_table(sids)
    step_tab = np.full((len(sids), c.max_zones_per_seq), -1, np.int32)
    for i, sid in enumerate(sids):
        step_tab[i, :len(c._seqs[sid].zones)] = c._seqs[sid].zones
        assert c._seqs[sid].length == int(lengths[i])
    assert np.array_equal(step_tab, tab.numpy())
    st = ps[0].stats
    assert c.stats["zones_allocated"] == st["zones_allocated"]
    assert c.stats["zones_reset"] == st["zones_reset"]
    assert c.stats["tokens_appended"] + c.stats["tokens_admitted"] == st["tokens_appended"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_admit_reserve_and_write_leave_what_appends_leave(dtype):
    rng = np.random.default_rng(0)
    c, ps = cache(dtype), pools(dtype)
    for sid, n in ((0, 5), (1, 3), (2, 8)):
        admit_both(c, ps, sid, *kv(rng, L, n, KV, HD))
    assert_same(c, ps, [0, 1, 2])
    for _ in range(5):                         # crosses zone boundaries
        step_both(c, ps, [2, 0, 1], rng)
    assert_same(c, ps, [2, 0, 1])
    for p in [c, *ps]:                         # reset, then reuse from the list's end
        p.evict(1)
    admit_both(c, ps, 7, *kv(rng, L, 4, KV, HD))
    for _ in range(3):
        step_both(c, ps, [7, 0, 2], rng)
    assert_same(c, ps, [7, 0, 2])
    assert c.utilization() == ps[0].utilization()


def test_a_step_s_tensors_are_one_copy_into_one_buffer(monkeypatch):
    rng = np.random.default_rng(1)
    c = cache()
    c.admit(4, *kv(rng, L, 4, KV, HD))
    c.admit(5, *kv(rng, L, 6, KV, HD))
    copies = []
    real = torch.Tensor.copy_
    monkeypatch.setattr(torch.Tensor, "copy_",
                        lambda t, src, *a, **kw: copies.append(t.shape) or real(t, src, *a, **kw))
    step = c.reserve([5, 4])
    assert copies == [(6 * 2 + 2 * 4,)]        # int64 zones and slots: 2 words a row each
    assert step.lengths.tolist() == [7, 5] and step.positions.tolist() == [6, 4]
    assert step.zones.tolist() == [c._seqs[5].zones[-1], c._seqs[4].zones[-1]]
    assert step.slots.tolist() == [2, 0]
    assert step.table.dtype == step.lengths.dtype == torch.int32
    assert step.zones.dtype == step.slots.dtype == torch.int64
    assert step.table.shape == (2, 4) and step.table.is_contiguous()
    assert step.table[1].tolist() == c._seqs[4].zones + [-1] * (4 - len(c._seqs[4].zones))
    again = c.reserve([5, 4])                      # the next step: the same addresses
    assert again.table.data_ptr() == step.table.data_ptr()
    assert step.lengths.tolist() == [8, 6]


@pytest.mark.parametrize("case", ["cap", "exhausted"])
def test_reserve_raises_what_appends_raise_and_changes_nothing(case):
    rng = np.random.default_rng(2)
    kw = dict(max_zones_per_seq=2) if case == "cap" else dict(num_zones=3)
    c, ps = cache(**kw), pools(**kw)
    admit_both(c, ps, 0, *kv(rng, L, 8, KV, HD))         # 2 zones, full
    admit_both(c, ps, 1, *kv(rng, L, 3, KV, HD))
    want = "max_zones_per_seq" if case == "cap" else "exhausted"
    with pytest.raises(KVZoneError, match=want):
        for b, sid in enumerate([1, 0]):
            ps[0].append(sid, *kv(rng, KV, HD))
    before = (list(c._free), {s: (list(st.zones), st.length) for s, st in c._seqs.items()},
              c.k.clone(), dict(c.stats))
    with pytest.raises(KVZoneError, match=want):
        c.reserve([1, 0])
    after = (list(c._free), {s: (list(st.zones), st.length) for s, st in c._seqs.items()},
             c.k.clone(), dict(c.stats))
    assert before[:2] == after[:2] and torch.equal(before[2], after[2])
    assert before[3] == after[3]


def test_admit_raises_what_extend_raises_and_changes_nothing():
    rng = np.random.default_rng(3)
    c = cache(num_zones=5, max_zones_per_seq=3)
    with pytest.raises(KVZoneError, match="max_zones_per_seq"):
        c.admit(0, *kv(rng, L, 13, KV, HD))
    c.admit(1, *kv(rng, L, 12, KV, HD))
    with pytest.raises(KVZoneError, match="exhausted"):
        c.admit(2, *kv(rng, L, 9, KV, HD))
    with pytest.raises(KVZoneError, match="exists"):
        c.admit(1, *kv(rng, L, 1, KV, HD))
    assert set(c._seqs) == {1} and c._free == [3, 4]
    assert c.stats["tokens_admitted"] == 12
    p = KVZonePool(num_zones=5, zone_len=4, kv_heads=KV, head_dim=HD, max_zones_per_seq=3,
                   device="cpu", dtype=torch.float32)
    p.add_sequence(0)
    with pytest.raises(KVZoneError, match="max_zones_per_seq"):
        p.extend(0, *kv(rng, 13, KV, HD))


def test_reserve_refuses_a_sequence_twice():
    c = cache()
    c.add_sequence(0)
    with pytest.raises(ValueError, match="twice"):
        c.reserve([0, 0])


def test_attend_is_the_pool_s_attend_on_its_layer():
    rng = np.random.default_rng(4)
    c, ps = cache(), pools()
    admit_both(c, ps, 0, *kv(rng, L, 6, KV, HD))
    admit_both(c, ps, 1, *kv(rng, L, 9, KV, HD))
    step = step_both(c, ps, [1, 0], rng)
    q = torch.from_numpy(rng.standard_normal((2, H, HD)).astype(np.float32))
    for layer, p in enumerate(ps):
        assert torch.equal(step.attend(layer, q), p.attend([1, 0], q))
