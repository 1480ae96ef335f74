"""The one traffic generator: seeded, the same set of work a round."""
import collections
import itertools

import numpy as np
import pytest

from zcsd_bench import spec, traffic

SCAN = spec.load_json(spec.HERE / "traffic" / "scan.json")
EXTENTS = spec.load_json(spec.HERE / "traffic" / "extents.json")
BLOCK = 4096
ZONE_BLOCKS = 275712                       # a 1,077 MiB zone
PER_ZONE = ZONE_BLOCKS * BLOCK // 1000     # its 1,000-byte records


def take(mix, seed, n, zones=4, blocks=ZONE_BLOCKS):
    return list(itertools.islice(traffic.commands(mix, zones, blocks, BLOCK, seed), n))


@pytest.mark.parametrize("mix", [SCAN, EXTENTS], ids=["scan", "extents"])
def test_same_seed_same_commands(mix):
    assert take(mix, 2**31 + 12345, 500) == take(mix, 2**31 + 12345, 500)
    assert take(mix, 1, 500) != take(mix, 2, 500)


def test_scan_rounds_cover_every_zone_once_from_its_start():
    cmds = take(SCAN, 7, 4 * 5)
    for r in range(5):
        rnd = cmds[4 * r: 4 * r + 4]
        assert sorted(c.zone for c in rnd) == list(range(4))
        assert all(c.block_off == 0 and c.n_blocks == ZONE_BLOCKS
                   and c.nbytes == ZONE_BLOCKS * BLOCK for c in rnd)


def test_a_scan_reads_the_blocks_that_hold_its_records():
    # record k of a zone is bytes [1000 k, 1000 (k + 1)): records 4 and 5
    # (bytes 4,000-5,999) lie in blocks 0 and 1; record 4,096 alone in
    # block 1,000 (bytes 4,096,000-4,096,999)
    def cmd(start, n):
        gen = traffic.commands(dict(EXTENTS, scan_records=[n, n]), 1, 2048, BLOCK, 0)
        real = traffic.scrambled_zipfian
        traffic.scrambled_zipfian = lambda rng, total, size: np.full(size, start)
        try:
            return next(gen)
        finally:
            traffic.scrambled_zipfian = real
    assert cmd(4, 2) == traffic.Command(0, 0, 2, 2 * BLOCK)
    assert cmd(4096, 1) == traffic.Command(0, 1000, 1, BLOCK)
    last = 2048 * BLOCK // 1000 - 1                 # a scan stops at the zone's end
    assert cmd(last, 100) == traffic.Command(0, last * 1000 // BLOCK, 1, BLOCK)


def test_extents_rounds_hold_every_scan_length_once_for_every_seed():
    for seed in (3, 2**40 + 1):
        cmds = take(EXTENTS, seed, 100 * 3)
        lengths = traffic.extent_lengths(EXTENTS, ZONE_BLOCKS, BLOCK)
        assert lengths == list(range(1, 26 + 1))
        for r in range(3):
            rnd = cmds[100 * r: 100 * (r + 1)]
            blocks = sum(c.n_blocks for c in rnd)
            # 1 + ... + 100 records of 1,000 bytes, in 4 KiB blocks, plus
            # at most one part block at each end of each scan
            assert 5050 * 1000 / BLOCK <= blocks <= 5050 * 1000 / BLOCK + 200
        for c in cmds:
            assert c.n_blocks in lengths and 0 <= c.zone < 4
            assert c.nbytes == c.n_blocks * BLOCK
            assert 0 <= c.block_off <= ZONE_BLOCKS - c.n_blocks


def test_scan_starts_are_ycsbs_scrambled_zipfian():
    rng = np.random.default_rng(5)
    keys = traffic.scrambled_zipfian(rng, 4 * PER_ZONE, 40000)
    assert keys.min() >= 0 and keys.max() < 4 * PER_ZONE
    top = collections.Counter(keys.tolist()).most_common(2)
    # YCSB's zipfian draws item 0 with probability 1 / zeta(1e10, 0.99)
    assert top[0][1] / 40000 == pytest.approx(1 / traffic.YCSB_ZETAN, rel=0.1)
    # item 1 with 0.5^0.99 / zeta; the hash puts them far apart
    assert top[1][1] / 40000 == pytest.approx(0.5 ** 0.99 / traffic.YCSB_ZETAN, rel=0.15)
    assert abs(top[0][0] - top[1][0]) > 1000
    # the two hottest keys are the hashes of items 0 and 1
    assert {k for k, _ in top} == set((traffic.fnv1a64(np.array([0, 1]))
                                       % (4 * PER_ZONE)).tolist())


def test_fnv1a64_is_the_64_bit_fnv1a_of_eight_little_endian_bytes():
    def plain(v):
        h = traffic.FNV_OFFSET_64
        for b in int(v).to_bytes(8, "little"):
            h = ((h ^ b) * traffic.FNV_PRIME_64) % 2**64
        return abs(h - 2**64 if h >= 2**63 else h)
    vals = np.array([0, 1, 255, 256, 2**40 + 7, 10**10], np.int64)
    assert traffic.fnv1a64(vals).tolist() == [plain(v) for v in vals]


def test_unsupported_mixes_are_refused():
    with pytest.raises(ValueError):
        take(dict(SCAN, clients=2), 1, 1)
    with pytest.raises(ValueError):
        take(dict(SCAN, loop="open"), 1, 1)
    with pytest.raises(ValueError):
        take(dict(SCAN, extent="rows"), 1, 1)
    with pytest.raises(ValueError):
        take(dict(EXTENTS, zipfian_theta=0.5), 1, 1)
    with pytest.raises(ValueError):
        take(dict(EXTENTS, scan_records=[0, 10]), 1, 1)
