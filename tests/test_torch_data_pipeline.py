"""The training-data pushdown in both packages: ZoneDataStore ->
ZoneDataPipeline -> NvmCsd or OffloadScheduler.

First the reference's ``tests/test_data_pipeline.py`` runs as it is written
against the port, with every ``from repro.`` import naming ``repro_torch.``
and the pipeline computing on ``device="cpu"`` (the plain PyTorch paths).
Then the same seeded corpus goes into a store of each package, on one
device and striped (raid0, raid1, and xor with a member offline), and the
two pipelines must agree exactly: every zone's surviving records, every
batch of two epochs, the histograms and ``PipelineStats``. Last, the jit
tier's record select, whose buffer is sized by the records of a row rather
than by the capacity, against the reference at a capacity above a row's
records. Every comparison is exact (bit for bit, dtype and shape).
"""
import dataclasses
import functools
from pathlib import Path

import jax
import jax.experimental
import numpy as np
import pytest
import torch

from repro.array import OffloadScheduler as RefScheduler
from repro.array import StripedZoneArray as RefArray
from repro.core import programs as rp
from repro.core.vm import jit_program as ref_jit_program
from repro.core.vm import run_oracle as ref_oracle
from repro.data import ZoneDataPipeline as RefPipeline
from repro.data import ZoneDataStore as RefStore
from repro.zns import ZonedDevice as RefZoned
from repro_torch.array import OffloadScheduler as PortScheduler
from repro_torch.array import StripedZoneArray as PortArray
from repro_torch.core import programs as tp
from repro_torch.core.vm import jit_program as port_jit_program
from repro_torch.core.vm import jit_program_batched as port_jit_program_batched
from repro_torch.data import ZoneDataPipeline as PortPipeline
from repro_torch.data import ZoneDataStore as PortStore
from repro_torch.zns import ZonedDevice as PortZoned

_REFERENCE = Path(__file__).with_name("test_data_pipeline.py")
exec(compile(_REFERENCE.read_text().replace("from repro.", "from repro_torch."),
             str(_REFERENCE), "exec"))
ZoneDataPipeline = functools.partial(ZoneDataPipeline, device="cpu")  # noqa: F821

BLOCK = 4096
# (seq_len, stripe_blocks): a 128-int32 stride of one page, and the
# chip_smoke shape's 3,072-int32 stride of three pages (chunks of 2 records)
SHAPES = [(127, 4), (2048, 6)]
LAYOUTS = [("single", 1, None), ("raid0", 4, None), ("raid1", 4, None),
           ("xor", 4, 1)]


@pytest.fixture(autouse=True)
def _x64_under_both_jax_apis(monkeypatch):
    """The reference enters 64-bit mode through ``jax.experimental.enable_x64``,
    which newer JAX releases dropped; give it the same context there."""
    if not hasattr(jax.experimental, "enable_x64"):
        monkeypatch.setattr(jax.experimental, "enable_x64",
                            lambda: jax.enable_x64(True), raising=False)


def corpus(seq_len, n_records, seed):
    """[(tokens, quality)] for zones 0 and 1, from one seeded generator:
    tokens in the granite-8b vocabulary, quality in [0, 100)."""
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 49152, (n, seq_len), dtype=np.int32),
             rng.integers(0, 100, n, dtype=np.int32)) for n in n_records]


def stores(layout, seq_len, stripe):
    """(reference store, port store) of one layout over the same corpus;
    with a dead member, it goes offline after the appends."""
    mode, n, dead = layout
    member_blocks = 96 if mode == "single" else 24      # 48+ logical blocks
    # zone 0: 38 or 42 blocks; under raid0 at stride 3,072, 7 chunks of 2
    # records each, far fewer than the zone's survivors
    data = corpus(seq_len, (300, 150) if seq_len < 1024 else (14, 7),
                  seed=seq_len)
    out = []
    for Zoned, Array, Store in ((RefZoned, RefArray, RefStore),
                                (PortZoned, PortArray, PortStore)):
        devs = [Zoned(num_zones=2, zone_bytes=member_blocks * BLOCK,
                      block_bytes=BLOCK) for _ in range(n)]
        device = devs[0] if mode == "single" else Array(
            devs, stripe_blocks=stripe, redundancy=mode)
        store = Store(device, seq_len)
        for zid, (tokens, quality) in enumerate(data):
            store.append_records(zid, tokens, quality)
        if dead is not None:
            for zid in range(2):
                device.set_offline(zid, device=dead)
        out.append(store)
    return out


def pipelines(layout, seq_len, stripe, **kw):
    ref_store, port_store = stores(layout, seq_len, stripe)
    return (RefPipeline(ref_store, **kw),
            PortPipeline(port_store, device="cpu", **kw))


def same(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return got.dtype == want.dtype and got.shape == want.shape \
        and got.tobytes() == want.tobytes()


@pytest.mark.parametrize("seq_len, stripe", SHAPES, ids=["stride128", "stride3072"])
@pytest.mark.parametrize("layout", LAYOUTS, ids=[f"{m}{n}" for m, n, _ in LAYOUTS])
def test_pipeline_matches_reference(layout, seq_len, stripe):
    """Records of each zone, two epochs of batches, histograms and stats."""
    ref, port = pipelines(layout, seq_len, stripe, batch=4, min_quality=50)
    if layout[0] != "single":
        assert isinstance(port.csd, PortScheduler)
        assert isinstance(ref.csd, RefScheduler)
    for zid in (0, 1):
        want = ref._zone_records(zid)
        assert want.shape[0] > 0
        assert same(port._zone_records(zid), want)
    want = list(ref.batches([0, 1], epochs=2, seed=3))
    got = list(port.batches([0, 1], epochs=2, seed=3))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        for key in ("tokens", "labels"):
            assert g[key].dtype == torch.int32 and g[key].device.type == "cpu"
            assert same(g[key].numpy(), w[key])
    for zid in (0, 1):
        assert same(port.histogram(zid, bins=16), ref.histogram(zid, bins=16))
    assert dataclasses.asdict(port.stats) == dataclasses.asdict(ref.stats)
    assert port.stats.movement_saved == ref.stats.movement_saved > 0


@pytest.mark.parametrize("tier", ["interp", "jit", "kernel"])
def test_pipeline_tiers_match_reference(tier):
    """Each tier the pipeline may be given (the kernel tier runs these
    record programs on the jit tier in both packages) on a raid0 array."""
    ref, port = pipelines(("raid0", 4, None), 2048, 6, batch=2,
                          min_quality=30, tier=tier)
    assert same(port._zone_records(0), ref._zone_records(0))
    assert dataclasses.asdict(port.stats) == dataclasses.asdict(ref.stats)


def test_pipeline_select_capacity_truncates_as_reference():
    """An explicit capacity below a zone's survivors keeps the first ones in
    stream order, in both packages and on the striped path."""
    ref, port = pipelines(("raid0", 4, None), 127, 4, batch=4, min_quality=20,
                          select_capacity=7)
    want = ref._zone_records(0)
    assert want.shape[0] == 7
    assert same(port._zone_records(0), want)


# ------------------------------------------------------- the bounded select

STRIDE = 128
CHUNK_PAGES = 2                       # 16 records of 128 int32 a chunk


def record_pages(n_chunks, seed):
    """[n_chunks, CHUNK_PAGES, 1024] int32 records, quality in [0, 100)."""
    rng = np.random.default_rng(seed)
    recs = rng.integers(-1000, 1000, (n_chunks, CHUNK_PAGES * 1024 // STRIDE, STRIDE),
                        dtype=np.int32)
    recs[:, :, 0] = rng.integers(0, 100, recs.shape[:2])
    return recs.reshape(n_chunks, CHUNK_PAGES, 1024)


def select_programs(cap):
    """(reference, port) programs: quality >= 40, then the record select
    and the field select, each at capacity ``cap``."""
    out = []
    for term in ("SELECT_REC", "SELECT"):
        pair = []
        for P in (rp, tp):
            pair.append(P.Program("int32", (
                P.Instruction(P.OpCode.FIELD, (STRIDE, 0)),
                P.Instruction(P.OpCode.CMP_GE, 40),
                P.Instruction(P.OpCode[term])), select_capacity=cap,
                name=f"q40_{term.lower()}"))
        out.append(tuple(pair))
    return out


@pytest.mark.parametrize("cap", [5, 16, 40, 3000])
def test_select_buffer_bounded_by_the_rows_records(cap):
    """A batched row holds at most its own records, so its buffer has
    ``min(cap, records)`` slots; the first ``min(n, slots)`` equal the
    reference oracle's over that chunk. The single form still returns the
    reference's ``cap`` slots (zeros past the matches), equal to the
    reference's jit tier."""
    pages = record_pages(3, seed=cap)
    per_chunk = CHUNK_PAGES * 1024 // STRIDE
    for ref_prog, port_prog in select_programs(cap):
        rec = ref_prog.terminal.op == rp.OpCode.SELECT_REC
        jp = port_jit_program_batched(port_prog, 3, CHUNK_PAGES, 1024, device="cpu")
        bufs, counts = jp.to_host(jp.launch(torch.from_numpy(pages)))
        slots = min(cap, per_chunk)
        assert bufs.shape == ((3, slots, STRIDE) if rec else (3, slots))
        for c in range(3):
            want_buf, want_n = ref_oracle(ref_prog, pages[c])
            assert counts[c] == want_n
            take = min(int(want_n), slots)
            assert same(bufs[c][:take], want_buf[:take])
        single = port_jit_program(port_prog, CHUNK_PAGES, 1024, device="cpu")(pages[0])
        want = ref_jit_program(ref_prog, CHUNK_PAGES, 1024)(pages[0])
        assert same(single[0], np.asarray(want[0]))
        assert int(single[1]) == int(want[1])
