"""The port's zoned KV pool against the JAX package's.

The five tests of ``tests/test_kv_zones.py`` run on the port's pool
(``device="cpu"``, where ``attend`` takes the plain PyTorch version of the
kernel). Then one scripted run of add/append/evict/attend goes through both
pools: zone tables, lengths, stats, utilization and the pools' K/V bits must
be equal, and ``attend`` within the reference tests' tolerance (2e-5 in
float32, 2e-2 in bfloat16).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_attn.ref import paged_attention_ref as jax_paged_attention_ref
from repro.serve.kv_zones import KVZonePool as JaxKVZonePool
from repro_torch.kernels.paged_attn.kernel import paged_attention_kernel
from repro_torch.kernels.paged_attn.ref import paged_attention_ref
from repro_torch.serve import KVZoneError, KVZonePool
from repro_torch.serve.kv_zones import pool_from_reference

KV, H, HD = 2, 4, 16
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def pool(**kw):
    args = dict(num_zones=8, zone_len=4, kv_heads=KV, head_dim=HD,
                max_zones_per_seq=3, dtype=torch.float32, device="cpu")
    args.update(kw)
    return KVZonePool(**args)


def tok(rng):
    return (torch.from_numpy(rng.standard_normal((KV, HD)).astype(np.float32)),
            torch.from_numpy(rng.standard_normal((KV, HD)).astype(np.float32)))


# ---------------------------------------------- tests/test_kv_zones.py, ported

def test_zone_allocation_on_demand():
    p = pool()
    p.add_sequence(0)
    rng = np.random.default_rng(0)
    for _ in range(9):                      # crosses two zone boundaries
        p.append(0, *tok(rng))
    tab, lengths = p.zone_table([0])
    assert int(lengths[0]) == 9
    assert int((tab[0] >= 0).sum()) == 3    # ceil(9/4) zones
    assert tab.dtype == lengths.dtype == torch.int32


def test_attend_matches_flat_cache():
    p = pool()
    rng = np.random.default_rng(1)
    p.add_sequence(7)
    ks, vs = [], []
    for _ in range(6):
        k, v = tok(rng)
        ks.append(k)
        vs.append(v)
        p.append(7, k, v)
    q = torch.from_numpy(rng.standard_normal((1, H, HD)).astype(np.float32))
    out = p.attend([7], q)
    kf = torch.stack(ks)[None]               # [1, 6, KV, HD]
    vf = torch.stack(vs)[None]
    qh = q.reshape(1, KV, H // KV, HD) * HD ** -0.5
    att = torch.einsum("bkgh,bskh->bkgs", qh, kf).softmax(-1)
    want = torch.einsum("bkgs,bskh->bkgh", att, vf).reshape(1, H, HD)
    torch.testing.assert_close(out, want, rtol=2e-5, atol=2e-5)


def test_eviction_resets_and_reuses_zones():
    p = pool(num_zones=3, max_zones_per_seq=3)
    rng = np.random.default_rng(2)
    p.add_sequence(0)
    for _ in range(12):                      # all 3 zones
        p.append(0, *tok(rng))
    with pytest.raises(KVZoneError):         # pool exhausted
        p.add_sequence(1)
        p.append(1, *tok(rng))
    p.evict(0)
    assert p.stats["zones_reset"] == 3
    for _ in range(4):                       # reclaimed zones serve seq 1
        p.append(1, *tok(rng))
    assert p.utilization() == pytest.approx(1 / 3)


def test_max_zones_per_seq_enforced():
    p = pool(max_zones_per_seq=1)
    p.add_sequence(0)
    rng = np.random.default_rng(3)
    for _ in range(4):
        p.append(0, *tok(rng))
    with pytest.raises(KVZoneError):
        p.append(0, *tok(rng))


def test_multi_sequence_isolation():
    p = pool()
    rng = np.random.default_rng(4)
    p.add_sequence(0)
    p.add_sequence(1)
    for _ in range(5):
        p.append(0, *tok(rng))
    for _ in range(3):
        p.append(1, *tok(rng))
    tab, lengths = p.zone_table([0, 1])
    assert int(lengths[0]) == 5 and int(lengths[1]) == 3
    z0 = {int(z) for z in tab[0] if z >= 0}
    z1 = {int(z) for z in tab[1] if z >= 0}
    assert not z0 & z1                        # no zone shared
    q = torch.from_numpy(rng.standard_normal((2, H, HD)).astype(np.float32))
    out = p.attend([0, 1], q)
    ref = paged_attention_ref(q, p.k, p.v, tab, lengths)
    torch.testing.assert_close(out, ref, rtol=2e-5, atol=2e-5)


# ------------------------------------------------- both pools, one script

def _bits(x) -> np.ndarray:
    """The bits of a jnp array or a torch tensor, as an integer array."""
    if isinstance(x, torch.Tensor):
        x = x.view(torch.int16) if x.dtype == torch.bfloat16 else x.view(torch.int32)
        return x.numpy()
    a = np.asarray(x)
    return a.view(np.int16 if a.itemsize == 2 else np.int32)


def _as_float(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _same_state(jp, tp, seq_ids):
    jtab, jlen = jp.zone_table(seq_ids)
    ttab, tlen = tp.zone_table(seq_ids)
    assert np.array_equal(np.asarray(jtab), ttab.numpy())
    assert np.array_equal(np.asarray(jlen), tlen.numpy())
    assert dict(jp.stats) == dict(tp.stats)
    assert jp.utilization() == tp.utilization()
    assert np.array_equal(_bits(jp.k), _bits(tp.k))
    assert np.array_equal(_bits(jp.v), _bits(tp.v))


def _script(dtype):
    """(reference pool, port pool) after the same run: three waves of
    sequences with evictions between them, attend after every step and
    state compared after every wave."""
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    args = dict(num_zones=10, zone_len=4, kv_heads=KV, head_dim=HD, max_zones_per_seq=4)
    jp = JaxKVZonePool(**args, dtype=jdt)
    tp = KVZonePool(**args, dtype=tdt, device="cpu")
    rng = np.random.default_rng(42)
    waves = [([0, 1, 2], 7), ([1, 2, 10, 11], 5), ([2, 10, 11, 20], 4)]
    evictions = [[0], [1, 11]]
    for w, (seq_ids, steps) in enumerate(waves):
        for sid in seq_ids:
            if sid not in tp._seqs:
                jp.add_sequence(sid)
                tp.add_sequence(sid)
        for _ in range(steps):
            for sid in seq_ids:
                k = rng.standard_normal((KV, HD)).astype(np.float32)
                v = rng.standard_normal((KV, HD)).astype(np.float32)
                jp.append(sid, jnp.asarray(k), jnp.asarray(v))
                tp.append(sid, torch.from_numpy(k), torch.from_numpy(v))
            q = rng.standard_normal((len(seq_ids), H, HD)).astype(np.float32)
            jq = jnp.asarray(q, jdt)
            want = jp.attend(seq_ids, jq)
            got = tp.attend(seq_ids, torch.from_numpy(q).to(tdt))
            assert got.dtype == tdt
            np.testing.assert_allclose(_as_float(got), _as_float(want),
                                       rtol=TOL[dtype], atol=TOL[dtype])
        _same_state(jp, tp, seq_ids)
        if w < len(evictions):
            for sid in evictions[w]:
                jp.evict(sid)
                tp.evict(sid)
            assert jp._free == tp._free
    return jp, tp


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_scripted_run_matches_reference_pool(dtype):
    jp, tp = _script(dtype)
    assert tp.stats["zones_reset"] == jp.stats["zones_reset"] > 0
    assert tp._free == jp._free
    assert paged_attention_kernel.launches == 0     # the CPU took the plain version


def test_pool_from_reference_keeps_the_bits():
    jp, _ = _script("bfloat16")
    seq_ids = sorted(jp._seqs)
    k, v = np.asarray(jp.k), np.asarray(jp.v)
    assert k.dtype.name == "bfloat16"
    tp = pool_from_reference(k, v, jp._seqs, jp._free, zone_len=jp.zone_len,
                             max_zones_per_seq=jp.max_zones_per_seq, device="cpu")
    assert tp.k.dtype == torch.bfloat16
    assert np.array_equal(_bits(jp.k), _bits(tp.k))
    assert np.array_equal(_bits(jp.v), _bits(tp.v))
    jtab, jlen = jp.zone_table(seq_ids)
    ttab, tlen = tp.zone_table(seq_ids)
    assert np.array_equal(np.asarray(jtab), ttab.numpy())
    assert np.array_equal(np.asarray(jlen), tlen.numpy())
    assert tp.utilization() == jp.utilization()
    q = np.random.default_rng(7).standard_normal((len(seq_ids), H, HD)).astype(np.float32)
    got = tp.attend(seq_ids, torch.from_numpy(q).to(torch.bfloat16))
    want = jax_paged_attention_ref(jnp.asarray(q, jnp.bfloat16), jp.k, jp.v, jtab, jlen)
    np.testing.assert_allclose(_as_float(got), _as_float(want), rtol=2e-2, atol=2e-2)
    # both pools go on allocating the same zones
    sid = min(seq_ids, key=lambda s: jp._seqs[s].length)
    k_tok = np.ones((KV, HD), np.float32)
    for _ in range(4):                        # fills one newly allocated zone
        jp.append(sid, jnp.asarray(k_tok), jnp.asarray(k_tok))
        tp.append(sid, torch.from_numpy(k_tok), torch.from_numpy(k_tok))
    assert jp._seqs[sid].zones == tp._seqs[sid].zones
    assert len(tp._seqs[sid].zones) > 1
    assert jp._free == tp._free
    assert np.array_equal(_bits(jp.k), _bits(tp.k))


def test_pool_from_reference_refuses_a_wrong_zone_len():
    k = np.zeros((4, 8, KV, HD), np.float32)
    with pytest.raises(ValueError, match="zone_len"):
        pool_from_reference(k, k, {}, range(4), zone_len=4, max_zones_per_seq=2,
                            device="cpu")


def test_append_casts_and_writes_in_place():
    p = pool(dtype=torch.bfloat16)
    k_store = p.k
    p.add_sequence(0)
    x = np.linspace(-1, 1, KV * HD, dtype=np.float64).reshape(KV, HD)
    p.append(0, torch.from_numpy(x), x)                    # float64 tensor, numpy array
    assert p.k is k_store                                  # no new pool tensor
    assert torch.equal(p.k[0, 0], torch.from_numpy(x).to(torch.bfloat16))
    assert torch.equal(p.v[0, 0], torch.from_numpy(x).to(torch.bfloat16))
    tab, lengths = p.zone_table([0])
    assert tab.device.type == lengths.device.type == "cpu"  # nothing crosses to a card


# ------------------------------------------- extend: n appends in zone runs

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("before,n", [(0, 4), (1, 9), (3, 2), (2, 0)])
def test_extend_matches_reference_appends(dtype, before, n):
    """``extend`` of n tokens after ``before`` single appends leaves the
    reference pool's state after the same n appends, bit for bit."""
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    args = dict(num_zones=6, zone_len=4, kv_heads=KV, head_dim=HD, max_zones_per_seq=4)
    jp = JaxKVZonePool(**args, dtype=jdt)
    tp = KVZonePool(**args, dtype=tdt, device="cpu")
    rng = np.random.default_rng(before * 10 + n)
    k = rng.standard_normal((before + n, KV, HD)).astype(np.float32)
    v = rng.standard_normal((before + n, KV, HD)).astype(np.float32)
    for sid in (0, 1):
        jp.add_sequence(sid)
        tp.add_sequence(sid)
    jp.append(1, jnp.asarray(k[0]), jnp.asarray(v[0]))     # sequence 0 starts on zone 1
    tp.append(1, torch.from_numpy(k[0]), torch.from_numpy(v[0]))
    for t in range(before):
        tp.append(0, torch.from_numpy(k[t]), torch.from_numpy(v[t]))
    tp.extend(0, torch.from_numpy(k[before:]), torch.from_numpy(v[before:]))
    for t in range(before + n):
        jp.append(0, jnp.asarray(k[t]), jnp.asarray(v[t]))
    _same_state(jp, tp, [0, 1])
    assert jp._free == tp._free


def test_extend_stops_where_append_would():
    """Past ``max_zones_per_seq`` extend raises as the append that crosses
    it would, with every token before that append written."""
    rng = np.random.default_rng(5)
    k = torch.from_numpy(rng.standard_normal((7, KV, HD)).astype(np.float32))
    one, many = pool(max_zones_per_seq=1), pool(max_zones_per_seq=1)
    for p in (one, many):
        p.add_sequence(0)
    for t in range(4):
        one.append(0, k[t], k[t])
    with pytest.raises(KVZoneError):
        one.append(0, k[4], k[4])
    with pytest.raises(KVZoneError):
        many.extend(0, k, k)
    assert torch.equal(one.k, many.k) and torch.equal(one.v, many.v)
    assert one._seqs[0] == many._seqs[0] and dict(one.stats) == dict(many.stats)
    with pytest.raises(ValueError, match="shape"):
        many.extend(0, k, k[:3])
