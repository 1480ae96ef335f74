"""The paged decode attention kernel (``kernels/paged_attn/csrc/paged_attn.cu``)
on the card against its plain version (``ref.py``), in float32 and bfloat16,
each case at the split ``kernel.py::plan`` picks and at one split a row, on
random tables with ``-1`` tails and the edge rows of ``paged_tables``; and
each plan's shared memory against the kernel's own (``pa_smem_bytes``).
Marked ``cuda``: skipped without an NVIDIA Hopper card, since the CUDA
kernel has no CPU mode. No JAX here, so the file runs on the card's machine:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_paged_attn_card.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.paged_attn import kernel as pa_kernel
from repro_torch.kernels.paged_attn import ref as pa_ref

# Attention geometries (H, KV, hd) of every attention model in
# src/repro/configs: granite-8b and llama-3.2-vision-11b, starcoder2-3b,
# h2o-danube-1.8b, recurrentgemma-9b, seamless-m4t-large-v2,
# command-r-plus-104b, deepseek-moe-16b, grok-1-314b.
CONFIG_GEOMETRIES = ((32, 8, 128), (24, 2, 128), (32, 8, 80), (16, 1, 256),
                     (16, 16, 64), (96, 8, 128), (16, 16, 128), (48, 8, 128))
# (B, H, KV, hd, NZ, ZL, MZ) of tests/test_kernels.py:145-149
TEST_GEOMETRIES = ((1, 4, 4, 32, 4, 16, 2), (2, 8, 2, 64, 8, 32, 3),
                   (4, 8, 1, 128, 16, 128, 4))
# every geometry above is one split of the kernel (kernel.py::plan: a split
# holds at least 256 slots); this one has three at a small ZL (16 zones a
# split), so the small head widths and the edge rows reach the combine as
# the granite pool's do
SPLIT_GEOMETRY = (8, 8, 2, 64, 64, 16, 48)
EDGE_ROWS = 8                   # paged_tables(edges=True) sets rows 0..7
# granite-8b (src/repro/configs/granite_8b.py) in its compute dtype, bf16:
# one layer's pool for 64 sequences at a 4K context, with spare zones
GRANITE_POOL = (64, 32, 8, 128, 4096, 128, 64)
# (atol, rtol): |kernel - ref.py| <= atol + rtol * |ref.py| everywhere. Both
# compute in float32 from the same inputs, so in float32 they differ by the
# order of the sums (3.6e-6 at most on an H100), and in bfloat16 the two
# float32 results may also round to neighbouring bfloat16 values, one step
# apart: at most 2**-7 of the value.
PAGED_TOL = {"float32": (2e-5, 2e-5), "bfloat16": (2e-5, 2**-7)}

# label: (B, H, KV, hd, NZ, ZL, MZ, edges)
CASES = {}
for _B, _H, _KV, _hd, _NZ, _ZL, _MZ in TEST_GEOMETRIES:
    CASES[f"test_{_H}_{_KV}_{_hd}"] = (_B, _H, _KV, _hd, _NZ, _ZL, _MZ, False)
    CASES[f"test_{_H}_{_KV}_{_hd}_edges"] = (EDGE_ROWS, _H, _KV, _hd, _NZ, _ZL, _MZ, True)
for _H, _KV, _hd in CONFIG_GEOMETRIES:
    CASES[f"config_{_H}_{_KV}_{_hd}"] = (EDGE_ROWS, _H, _KV, _hd, 64, 16, 6, True)
# 64 query heads on one KV head: more columns than a CTA's 8 consumer warps,
# so each sequence's heads are cut over 2 CTAs
CASES["wide_group_64_1_64"] = (EDGE_ROWS, 64, 1, 64, 64, 16, 6, True)
CASES["splits"] = (*SPLIT_GEOMETRY, False)
CASES["splits_edges"] = (*SPLIT_GEOMETRY, True)
CASES["granite_8b_pool"] = (*GRANITE_POOL, True)


@pytest.fixture
def card():
    """The card, with TF32 off so that ref.py's float32 einsums are float32."""
    if not torch.cuda.is_available() or torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("needs an NVIDIA Hopper card (sm_90a): the CUDA kernel has no CPU mode")
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def paged_tables(rng, B, NZ, ZL, MZ, edges, zps):
    """(zone_table [B, MZ] int32, lengths [B] int32) on the host: random
    distinct zones with a -1 tail and a length inside them, as
    tests/test_kernels.py::_paged_case draws them. With ``edges`` (B >=
    EDGE_ROWS) row 0 has length 0, row 1 an all -1 table, row 2 a -1 hole
    in a full row, row 3 all MZ*ZL positions and row 4 a length that is a
    multiple of ZL. Rows 5-7 sit at the kernel's splits of ``zps`` zones, in
    full rows: row 5 has its second split all -1, row 6 valid zones in its
    last split only, row 7 a length one token past the first split's end.
    In a one-split table rows 5 and 6 keep only their last zone and row 7
    one token of its last zone."""
    tab = np.full((B, MZ), -1, np.int32)
    lengths = np.zeros(B, np.int32)
    for b in range(B):
        nz = rng.integers(1, MZ + 1)
        tab[b, :nz] = rng.choice(NZ, size=nz, replace=False)
        lengths[b] = rng.integers(1, nz * ZL + 1)
    if edges:
        lengths[0] = 0
        tab[1], lengths[1] = -1, 2 * ZL
        tab[2] = rng.choice(NZ, size=MZ, replace=False)
        tab[2, MZ // 2] = -1
        lengths[2] = MZ * ZL
        tab[3] = rng.choice(NZ, size=MZ, replace=False)
        lengths[3] = MZ * ZL
        lengths[4] = (tab[4] >= 0).sum() * ZL
        for r in (5, 6, 7):
            tab[r] = rng.choice(NZ, size=MZ, replace=False)
            lengths[r] = MZ * ZL
        if zps < MZ:
            tab[5, zps:2 * zps] = -1
            tab[6, :(-(-MZ // zps) - 1) * zps] = -1
            lengths[7] = zps * ZL + 1
        else:
            tab[5:7, :MZ - 1] = -1
            lengths[7] = (MZ - 1) * ZL + 1
    return tab, lengths


def paged_inputs(B, H, KV, hd, NZ, ZL, MZ, dtype, seed, edges, zps):
    """q, K, V drawn on the card from a seeded generator; the tables from a
    seeded numpy draw."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    tdt = getattr(torch, dtype)
    q = torch.randn(B, H, hd, generator=g, device="cuda", dtype=tdt)
    k = torch.randn(NZ, ZL, KV, hd, generator=g, device="cuda", dtype=tdt)
    v = torch.randn(NZ, ZL, KV, hd, generator=g, device="cuda", dtype=tdt)
    tab, lengths = paged_tables(np.random.default_rng(seed), B, NZ, ZL, MZ, edges, zps)
    return q, k, v, torch.from_numpy(tab).cuda(), torch.from_numpy(lengths).cuda()


def paged_close(got, want):
    """(ok, max_abs_err, share) of a paged_attention result against ref.py:
    ``share`` is the largest |got - want| over its limit in PAGED_TOL, so
    ok needs a share <= 1, the same dtype and shape, and finite values."""
    atol, rtol = PAGED_TOL[str(want.dtype).removeprefix("torch.")]
    diff = (got.float() - want.float()).abs()
    share = float((diff / (atol + rtol * want.float().abs())).max())
    ok = (got.dtype == want.dtype and got.shape == want.shape
          and bool(torch.isfinite(got).all()) and share <= 1.0)
    return ok, float(diff.max()), share


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(PAGED_TOL))
@pytest.mark.parametrize("case", list(CASES))
def test_the_kernel_is_the_plain_version_at_its_split_and_at_one(card, case, dtype,
                                                                  record_property):
    B, H, KV, hd, NZ, ZL, MZ, edges = CASES[case]
    itemsize = torch.empty(0, dtype=getattr(torch, dtype)).element_size()
    plan = pa_kernel.plan(B, H, KV, hd, MZ, ZL, itemsize,
                          torch.cuda.get_device_properties(0).multi_processor_count)
    assert pa_kernel.load().pa_smem_bytes(
        int(dtype == "bfloat16"), H, KV, hd, plan.kv_chunk, plan.head_groups,
        plan.stage_tokens, plan.stages) == plan.smem
    q, k, v, tab, lengths = paged_inputs(B, H, KV, hd, NZ, ZL, MZ, dtype,
                                         seed=500 + list(CASES).index(case), edges=edges,
                                         zps=plan.zones_per_split)
    want = pa_ref.paged_attention_ref(q, k, v, tab, lengths)
    splits = sorted({plan.zones_per_split, MZ})
    results = {}
    for zps in splits:
        got = pa_kernel.paged_attention_kernel(q, k, v, tab, lengths, zones_per_split=zps)
        results[f"S={-(-MZ // zps)}"] = paged_close(got, want)
    record_property("checks", len(splits))
    record_property(f"max_abs_err.paged_attention.{dtype}", max(r[1] for r in results.values()))
    record_property(f"share_of_limit.paged_attention.{dtype}",
                    max(r[2] for r in results.values()))
    assert all(ok for ok, _, _ in results.values()), results
