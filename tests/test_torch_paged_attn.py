"""The port's paged decode attention against the JAX package's.

On the CPU the port's wrapper takes its plain PyTorch version
(``repro_torch/kernels/paged_attn/ref.py``); the reference's Pallas kernel
runs in interpret mode, as its own tests run it, and its jnp oracle beside
it. The same numpy inputs go to both packages: float32 directly, bfloat16
as the bits of the jnp array (viewed as uint16, then as torch.bfloat16).
Tolerances are the reference tests': 2e-5 in float32, 2e-2 in bfloat16,
where the two round at other places.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_attn.ops import paged_attention as jax_paged_attention
from repro.kernels.paged_attn.ref import paged_attention_ref as jax_paged_attention_ref
from repro_torch.kernels.paged_attn import kernel as pa_kernel
from repro_torch.kernels.paged_attn import paged_attention
from repro_torch.kernels.paged_attn.ref import (paged_attention_ref,
                                                paged_attention_split_ref)
from repro_torch.serve import KVZonePool

TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _tables(rng, B, NZ, ZL, MZ):
    """Random distinct zones per sequence with a -1 tail and a length inside
    them (tests/test_kernels.py::_paged_case)."""
    ztab = np.full((B, MZ), -1, np.int32)
    lengths = np.zeros((B,), np.int32)
    for b in range(B):
        nz = rng.integers(1, MZ + 1)
        ztab[b, :nz] = rng.choice(NZ, size=nz, replace=False)
        lengths[b] = rng.integers(1, nz * ZL + 1)
    return ztab, lengths


def _to_torch(x):
    """A jnp array as a torch tensor with the same bits."""
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _inputs(B, H, KV, hd, NZ, ZL, MZ, seed, dtype="float32", edit=None):
    """(jnp inputs, torch inputs) from one numpy draw; ``edit(ztab,
    lengths)`` changes the tables in place before both sides see them."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, hd)).astype(np.float32)
    k = rng.standard_normal((NZ, ZL, KV, hd)).astype(np.float32)
    v = rng.standard_normal((NZ, ZL, KV, hd)).astype(np.float32)
    ztab, lengths = _tables(rng, B, NZ, ZL, MZ)
    if edit is not None:
        edit(ztab, lengths)
    jx = tuple(jnp.asarray(a, getattr(jnp, dtype)) for a in (q, k, v)) + (
        jnp.asarray(ztab), jnp.asarray(lengths))
    tx = tuple(_to_torch(a) for a in jx)
    return jx, tx


def _assert_close(got: torch.Tensor, want, tol: float):
    assert got.dtype == _to_torch(want).dtype
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _check_both(jx, tx, dtype):
    got = paged_attention(*tx)
    _assert_close(got, jax_paged_attention(*jx, interpret=True), TOL[dtype])
    _assert_close(got, jax_paged_attention_ref(*jx), TOL[dtype])
    return got


# tests/test_kernels.py:145-149
GEOMETRIES = [
    (1, 4, 4, 32, 4, 16, 2),     # MHA
    (2, 8, 2, 64, 8, 32, 3),     # GQA
    (4, 8, 1, 128, 16, 128, 4),  # MQA, bigger zones
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,KV,hd,NZ,ZL,MZ", GEOMETRIES)
def test_paged_attention_matches_reference(B, H, KV, hd, NZ, ZL, MZ, dtype):
    jx, tx = _inputs(B, H, KV, hd, NZ, ZL, MZ, seed=B, dtype=dtype)
    _check_both(jx, tx, dtype)


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4, 5, 6, 7])
def test_paged_attention_random_tables(seed):
    jx, tx = _inputs(3, 6, 2, 32, 8, 16, 4, seed=1000 + seed)
    _check_both(jx, tx, "float32")


def test_paged_attention_bf16():
    jx, tx = _inputs(2, 8, 4, 64, 6, 32, 3, seed=9, dtype="bfloat16")
    _check_both(jx, tx, "bfloat16")


def _length_zero(ztab, lengths):
    lengths[0] = 0


def _all_minus_one(ztab, lengths):
    ztab[1] = -1
    lengths[1] = 2 * 16


def _hole_in_the_middle(ztab, lengths):
    ztab[2] = [5, -1, 6, 7]
    lengths[2] = 4 * 16


def _full_length(ztab, lengths):
    ztab[0] = [3, 1, 4, 0]
    lengths[0] = 4 * 16


def _first_zone_unused(ztab, lengths):
    ztab[1] = [-1, 2, -1, -1]
    lengths[1] = 16 + 5


EDGES = {"length_zero": _length_zero, "all_minus_one": _all_minus_one,
         "hole_in_the_middle": _hole_in_the_middle, "full_length": _full_length,
         "first_zone_unused": _first_zone_unused}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("edge", sorted(EDGES))
def test_paged_attention_edge_rows(edge, dtype):
    jx, tx = _inputs(3, 8, 2, 32, 8, 16, 4, seed=21, dtype=dtype, edit=EDGES[edge])
    _check_both(jx, tx, dtype)


def test_no_valid_position_is_the_uniform_mean_of_v():
    """A row with no valid position reads every clamped position with the same
    weight: zone 0 once for each -1 entry."""
    _, (q, k, v, tab, lengths) = _inputs(3, 8, 2, 32, 8, 16, 4, seed=5,
                                         edit=_length_zero)
    got = paged_attention(q, k, v, tab, lengths)
    safe = tab[0].long().clamp(min=0)
    want = v[safe].reshape(-1, 2, 32).mean(0)              # [KV, hd]
    torch.testing.assert_close(got[0].reshape(2, 4, 32),
                               want[:, None, :].expand(2, 4, 32),
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_attention_head_dim_80(dtype):
    jx, tx = _inputs(2, 32, 8, 80, 6, 16, 3, seed=80, dtype=dtype)
    _check_both(jx, tx, dtype)


def test_cpu_call_launches_nothing():
    before = pa_kernel.paged_attention_kernel.launches
    _, tx = _inputs(2, 8, 2, 64, 8, 32, 3, seed=3)
    out = pa_kernel.paged_attention_kernel(*tx)
    assert torch.equal(out, paged_attention_ref(*tx))
    assert pa_kernel.paged_attention_kernel.launches == before == 0


def test_kernel_wrapper_and_pool_refuse_a_missing_card(monkeypatch):
    """Tensors that are neither on the CPU nor on a card are refused, not
    sent to the plain version; the pool asked for the card without one
    raises."""
    _, tx = _inputs(2, 8, 2, 64, 8, 32, 3, seed=3)
    with pytest.raises(ValueError, match="unsupported device"):
        pa_kernel.paged_attention_kernel(*(t.to("meta") for t in tx))
    assert pa_kernel.paged_attention_kernel.launches == 0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        KVZonePool(num_zones=2, zone_len=4, kv_heads=1, head_dim=8,
                   max_zones_per_seq=1)


def _bad(change):
    def make():
        _, (q, k, v, tab, lengths) = _inputs(2, 8, 2, 64, 8, 32, 3, seed=3)
        return change(q, k, v, tab, lengths)
    return make


BAD_INPUTS = {
    "head_dim_not_multiple_of_8": (_bad(lambda q, k, v, t, n: (
        q[..., :60].contiguous(), k[..., :60].contiguous(), v[..., :60].contiguous(),
        t, n)), ValueError),
    "head_dim_above_256": (_bad(lambda q, k, v, t, n: (
        q.repeat(1, 1, 5), k.repeat(1, 1, 1, 5), v.repeat(1, 1, 1, 5), t, n)), ValueError),
    "heads_not_multiple_of_kv": (_bad(lambda q, k, v, t, n: (
        q[:, :7].contiguous(), k, v, t, n)), ValueError),
    "float16": (_bad(lambda q, k, v, t, n: (q.half(), k.half(), v.half(), t, n)), TypeError),
    "mixed_dtypes": (_bad(lambda q, k, v, t, n: (q.bfloat16(), k, v, t, n)), TypeError),
    "int64_table": (_bad(lambda q, k, v, t, n: (q, k, v, t.long(), n)), ValueError),
    "short_lengths": (_bad(lambda q, k, v, t, n: (q, k, v, t, n[:1])), ValueError),
    "strided_pool": (_bad(lambda q, k, v, t, n: (
        q, k.transpose(0, 1), v.transpose(0, 1), t, n)), ValueError),
    "v_shape": (_bad(lambda q, k, v, t, n: (q, k, v[:4], t, n)), ValueError),
}


@pytest.mark.parametrize("case", sorted(BAD_INPUTS))
def test_kernel_checks_refuse_what_it_does_not_take(case):
    make, error = BAD_INPUTS[case]
    with pytest.raises(error):
        pa_kernel._check(*make())


def test_kernel_checks_accept_the_main_path_shapes():
    for dtype in ("float32", "bfloat16"):
        _, tx = _inputs(2, 32, 8, 80, 6, 16, 3, seed=1, dtype=dtype)
        pa_kernel._check(*tx)


# ------------------------------------------------- the kernel's split algebra

# (B, H, KV, hd, NZ, ZL, MZ) with several splits: the kernel's plan gives 8
# zones a split (256 slots), 3 splits, the last of them short
SPLIT_GEOMETRY = (3, 8, 2, 32, 24, 32, 20)
_NZ, _ZL, _MZ = SPLIT_GEOMETRY[4:]
H100_SMS = 132
# granite-8b's decode shapes (src/repro/configs/granite_8b.py; chip_smoke.py's
# serve phase and its timing row): (B, H, KV, hd, MZ, ZL), bf16
SERVE_SHAPE = (32, 32, 8, 128, 64, 128)
TIMING_SHAPE = (64, 32, 8, 128, 64, 128)
ZONES_PER_SPLIT = {
    "one": 1, "two": 2, "whole_row": _MZ,
    "split_layout": pa_kernel.plan(*SPLIT_GEOMETRY[:4], _MZ, _ZL, 4, H100_SMS).zones_per_split,
    # the split plan() picks at the serve shape, on this table
    "serve_plan": pa_kernel.plan(*SERVE_SHAPE, 2, H100_SMS).zones_per_split,
}


def _full_row(ztab, lengths):
    """Row 0 holds MZ distinct zones, every position valid."""
    ztab[0] = np.random.default_rng(0).choice(_NZ, size=_MZ, replace=False)
    lengths[0] = _MZ * _ZL


def _first_split_zones(zps):
    """The zones before row 0's last split: all of them but its last zone
    when the row is one split."""
    S = -(-_MZ // zps)
    return (S - 1) * zps if S > 1 else _MZ - 1


def _split_length_zero(ztab, lengths, zps):
    lengths[0] = 0


def _split_all_minus_one(ztab, lengths, zps):
    ztab[0] = -1
    lengths[0] = 2 * _ZL


def _split_hole(ztab, lengths, zps):
    _full_row(ztab, lengths)
    ztab[0, _MZ // 2] = -1


def _split_full_length(ztab, lengths, zps):
    _full_row(ztab, lengths)


def _split_length_multiple_of_zl(ztab, lengths, zps):
    lengths[0] = (ztab[0] >= 0).sum() * _ZL


def _minus_one_run_over_a_split(ztab, lengths, zps):
    """The second split all -1 (all zones but the last in a one-split row)."""
    _full_row(ztab, lengths)
    if zps < _MZ:
        ztab[0, zps:2 * zps] = -1
    else:
        ztab[0, :_MZ - 1] = -1


def _valid_only_in_last_split(ztab, lengths, zps):
    _full_row(ztab, lengths)
    ztab[0, :_first_split_zones(zps)] = -1


def _one_past_a_split_boundary(ztab, lengths, zps):
    _full_row(ztab, lengths)
    lengths[0] = (zps if zps < _MZ else _MZ - 1) * _ZL + 1


SPLIT_EDGES = {
    "length_zero": _split_length_zero, "all_minus_one": _split_all_minus_one,
    "hole": _split_hole, "full_length": _split_full_length,
    "length_multiple_of_zl": _split_length_multiple_of_zl,
    "minus_one_run_over_a_split": _minus_one_run_over_a_split,
    "valid_only_in_last_split": _valid_only_in_last_split,
    "one_past_a_split_boundary": _one_past_a_split_boundary,
}
_jax_outputs = {}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("zps", sorted(ZONES_PER_SPLIT))
@pytest.mark.parametrize("edge", sorted(SPLIT_EDGES))
def test_split_reference_matches_reference(edge, zps, dtype):
    """The kernel's split algebra (per-split softmax states, the uniform rule
    for a row with no valid position, -1e30/0 for a split that reads
    nothing, and their combine) against the JAX package's kernel and its
    jnp oracle."""
    zps = ZONES_PER_SPLIT[zps]
    jx, tx = _inputs(*SPLIT_GEOMETRY, seed=31, dtype=dtype,
                     edit=lambda t, n: SPLIT_EDGES[edge](t, n, zps))
    key = (np.asarray(jx[3]).tobytes(), np.asarray(jx[4]).tobytes(), dtype)
    if key not in _jax_outputs:
        _jax_outputs[key] = (jax_paged_attention(*jx, interpret=True),
                             jax_paged_attention_ref(*jx))
    got = paged_attention_split_ref(*tx, zones_per_split=zps)
    for want in _jax_outputs[key]:
        _assert_close(got, want, TOL[dtype])


def test_split_layout_at_granite_width():
    """plan() at granite width on an H100's 132 SMs: one CTA a sequence
    (all 8 KV heads), 16 tokens a stage in bf16 (64 KiB of K and V), and
    about 4 waves of CTAs at a full table: 8 zones a split for 64
    sequences, 4 for the serve step's 32."""
    timing = pa_kernel.plan(*TIMING_SHAPE, 2, H100_SMS)
    assert (timing.kv_chunk, timing.head_groups, timing.stage_tokens) == (8, 1, 16)
    assert (timing.zones_per_split, timing.splits, timing.ctas) == (8, 8, 512)
    serve = pa_kernel.plan(*SERVE_SHAPE, 2, H100_SMS)
    assert (serve.zones_per_split, serve.splits) == (4, 16)
    assert pa_kernel.plan(*SPLIT_GEOMETRY[:4], _MZ, _ZL, 4, H100_SMS).splits == 3


# chip_smoke.py::CONFIG_GEOMETRIES: (H, KV, hd) of every attention model in
# src/repro/configs
CONFIG_GEOMETRIES = ((32, 8, 128), (24, 2, 128), (32, 8, 80), (16, 1, 256),
                     (16, 16, 64), (96, 8, 128), (16, 16, 128), (48, 8, 128))
PLAN_SHAPES = {"timing": TIMING_SHAPE, "serve": SERVE_SHAPE,
               **{f"config_{H}_{KV}_{hd}": (8, H, KV, hd, 64, 128)
                  for H, KV, hd in CONFIG_GEOMETRIES},
               "split_geometry": (*SPLIT_GEOMETRY[:4], _MZ, _ZL),
               # more columns of 4 heads than a CTA's 8 consumer warps
               "wide_group": (8, 64, 1, 64, 6, 16)}


@pytest.mark.parametrize("sms", [H100_SMS, 4])
@pytest.mark.parametrize("itemsize", [4, 2], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("shape", sorted(PLAN_SHAPES))
def test_plan_splits_cover_every_zone_once(shape, itemsize, sms):
    """S >= 1 splits of zps zones; each zone of the table in exactly one."""
    B, H, KV, hd, MZ, ZL = PLAN_SHAPES[shape]
    p = pa_kernel.plan(B, H, KV, hd, MZ, ZL, itemsize, sms)
    assert p.splits >= 1 and 1 <= p.zones_per_split <= MZ
    assert p.splits == -(-MZ // p.zones_per_split)
    owner = [z // p.zones_per_split for z in range(MZ)]
    assert sorted(set(owner)) == list(range(p.splits))       # no split is empty
    seen = [0] * MZ
    for s in range(p.splits):
        for z in range(s * p.zones_per_split, min((s + 1) * p.zones_per_split, MZ)):
            seen[z] += 1
    assert seen == [1] * MZ
    assert p.zones_per_split * ZL >= min(MZ * ZL, pa_kernel.MIN_SPLIT_TOKENS)
    per_seq = p.ctas // (B * p.splits)
    assert per_seq * B * p.splits == p.ctas and per_seq >= 1


@pytest.mark.parametrize("sms", [H100_SMS, 4])
@pytest.mark.parametrize("itemsize", [4, 2], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("shape", sorted(PLAN_SHAPES))
def test_plan_takes_one_split_where_the_grid_fills_the_card(shape, itemsize, sms):
    """With enough sequences for more than two waves of CTAs, S = 1; with
    fewer, the split keeps about WAVES waves at a full table."""
    _, H, KV, hd, MZ, ZL = PLAN_SHAPES[shape]
    one = pa_kernel.plan(1, H, KV, hd, MZ, ZL, itemsize, sms)
    per_seq = one.ctas // one.splits
    B = -(-2 * sms // per_seq) + 1                             # > 2 waves alone
    assert pa_kernel.plan(B, H, KV, hd, MZ, ZL, itemsize, sms).splits == 1
    p = pa_kernel.plan(*PLAN_SHAPES[shape], itemsize, sms)
    rows = p.ctas // p.splits
    if rows * 2 < sms * pa_kernel.WAVES and p.zones_per_split * ZL > pa_kernel.MIN_SPLIT_TOKENS:
        assert p.ctas >= sms * pa_kernel.WAVES // 2


@pytest.mark.parametrize("itemsize", [4, 2], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("shape", sorted(PLAN_SHAPES))
def test_stage_plan_fits_a_block(shape, itemsize):
    """The ring of at least 3 stages, each at least one token, fits the
    232,448 bytes a block may use; every bulk copy (a run of 1 to
    stage_tokens rows) is a multiple of 16 bytes; the CTA's columns fit its
    consumer warps, one each."""
    B, H, KV, hd, MZ, ZL = PLAN_SHAPES[shape]
    p = pa_kernel.plan(B, H, KV, hd, MZ, ZL, itemsize, H100_SMS)
    assert p.stages >= 3 and 1 <= p.stage_tokens <= pa_kernel.MAX_STAGE_TOKENS
    ring = p.stages * 2 * p.stage_tokens * p.row_bytes
    assert ring <= p.smem <= pa_kernel.SMEM_LIMIT == 232_448
    assert p.row_bytes == p.kv_chunk * hd * itemsize
    assert all(n * p.row_bytes % 16 == 0 for n in range(1, p.stage_tokens + 1))
    assert KV % p.kv_chunk == 0
    G = H // KV
    assert -(-G // pa_kernel.HEADS_A_COLUMN) % p.head_groups == 0
    assert p.kv_chunk * p.head_groups <= pa_kernel.CONSUMER_WARPS
    assert p.smem == pa_kernel.smem_bytes(hd, itemsize, p.kv_chunk, p.stage_tokens, p.stages)
