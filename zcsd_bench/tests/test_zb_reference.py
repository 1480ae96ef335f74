"""The plain reference against hand-counted zones."""
import numpy as np

from zcsd_bench import spec

REF = spec.load_module(spec.HERE / "reference" / "filter_count.py")
PROGRAM = {"dtype": "int32", "cmp": "gt", "threshold": 5}
BLOCK = 16                         # 4 int32 a block


def test_counts_full_and_sub_extents_by_hand():
    zones = [np.array([1, 5, 9, 2, 7, 7, 0, 10, 6, 6, 6, 6], np.int32),
             np.array([5, 5, 5, 5, 0, 0, 0, 0, 100, -1, 6, 5], np.int32)]
    t = REF.table(zones, PROGRAM, BLOCK)
    assert t.value(0, 0, 3) == 1 + 3 + 4
    assert t.value(0, 1, 1) == 3
    assert t.value(0, 1, 2) == 7
    assert t.value(1, 0, 3) == 2
    assert t.value(1, 0, 2) == 0
    assert t.value(1, 2, 1) == 2


def test_other_comparisons():
    zones = [np.array([1, 5, 9, 2], np.int32)]
    for cmp, want in (("ge", 2), ("lt", 2), ("le", 3), ("eq", 1), ("ne", 3)):
        assert REF.table(zones, dict(PROGRAM, cmp=cmp), BLOCK).value(0, 0, 1) == want


def test_control_miscounts_values_float32_cannot_tell_apart():
    thr = 2**30 - 1                     # RAND_MAX // 2
    zones = [np.array([2**30, 2**30 + 63, thr, 5], np.int32)]
    prog = dict(PROGRAM, threshold=thr)
    assert REF.table(zones, prog, BLOCK).value(0, 0, 1) == 2
    assert REF.table(zones, prog, BLOCK, control=True).value(0, 0, 1) == 0


def test_control_agrees_far_from_the_threshold():
    zones = [np.array([0, 2**31 - 1, 2**29, 2**30 + 4096], np.int32)]
    prog = dict(PROGRAM, threshold=2**30 - 1)
    assert (REF.table(zones, prog, BLOCK).value(0, 0, 1)
            == REF.table(zones, prog, BLOCK, control=True).value(0, 0, 1) == 2)
