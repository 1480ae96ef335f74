"""Analytics offload on the PyTorch port: the paper's data-processing use
case on record data.

A zone holds fixed-stride records [store_id, amount, status, pad...]; all
aggregation runs device-side through verified programs — the host receives
scalars and histograms, never the table. This is the YourSQL/Ibex-style
query pushdown the paper positions ZCSD to prototype.

    PYTHONPATH=src python examples/torch_csd_pushdown_analytics.py        # the card
    PYTHONPATH=src python examples/torch_csd_pushdown_analytics.py --device cpu
"""
import argparse

import numpy as np

from repro_torch.core import CsdTier, NvmCsd, field_reduce
from repro_torch.core.programs import Instruction, OpCode, Program, select_records
from repro_torch.zns import ZonedDevice

STRIDE = 8           # record: [store_id, amount, status, 5 x pad]
N_RECORDS = 128 * 1024


def check(cond, msg):
    if not cond:
        raise SystemExit(msg)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="torch device of the offload tiers")
    args = ap.parse_args()

    dev = ZonedDevice(num_zones=1, zone_bytes=8 * 1024 * 1024,
                      block_bytes=4096)
    rng = np.random.default_rng(7)
    recs = np.zeros((N_RECORDS, STRIDE), np.int32)
    recs[:, 0] = rng.integers(0, 50, N_RECORDS)          # store_id
    recs[:, 1] = rng.integers(1, 10_000, N_RECORDS)      # amount (cents)
    recs[:, 2] = rng.integers(0, 3, N_RECORDS)           # status (2 = refund)
    dev.zone_append(0, recs)
    csd = NvmCsd(dev, device=args.device)
    table_mb = recs.nbytes / 1e6

    # Q1: SELECT SUM(amount) — device-side field reduce
    q1 = field_reduce("int32", STRIDE, 1, kind="sum")
    st = csd.nvm_cmd_bpf_run(q1, 0, tier=CsdTier.JIT)
    total = int(csd.nvm_cmd_bpf_result())
    check(total == int(recs[:, 1].sum()), f"Q1 {total}")
    print(f"Q1 SUM(amount) = {total}   "
          f"[{st.bytes_returned} B back vs {table_mb:.1f} MB table; "
          f"saved {st.movement_saved_bytes / 1e6:.1f} MB]")

    # Q2: SELECT COUNT(*) WHERE status == 2
    q2 = Program("int32", (Instruction(OpCode.FIELD, (STRIDE, 2)),
                           Instruction(OpCode.CMP_EQ, 2),
                           Instruction(OpCode.RED_COUNT)), name="refunds")
    st = csd.nvm_cmd_bpf_run(q2, 0, tier=CsdTier.JIT)
    refunds = int(csd.nvm_cmd_bpf_result())
    check(refunds == int((recs[:, 2] == 2).sum()), f"Q2 {refunds}")
    print(f"Q2 COUNT(refunds) = {refunds}   "
          f"[saved {st.movement_saved_bytes / 1e6:.1f} MB]")

    # Q3: histogram of amounts (device-side GROUP BY bucket)
    q3 = Program("int32", (Instruction(OpCode.FIELD, (STRIDE, 1)),
                           Instruction(OpCode.RED_HIST, (0, 10_000, 10))),
                 name="amount_hist")
    st = csd.nvm_cmd_bpf_run(q3, 0, tier=CsdTier.JIT)
    hist = np.asarray(csd.nvm_cmd_bpf_result())
    print(f"Q3 amount histogram: {hist.tolist()}   "
          f"[{st.bytes_returned} B back]")

    # Q4: SELECT * WHERE amount > 9900 — record-granular pushdown select
    q4 = select_records("int32", STRIDE, 1, "gt", 9900, capacity=4096)
    st = csd.nvm_cmd_bpf_run(q4, 0, tier=CsdTier.JIT)
    rows, count = csd.nvm_cmd_bpf_result()
    rows = np.asarray(rows)[: int(count)]
    np.testing.assert_array_equal(rows, recs[recs[:, 1] > 9900])
    print(f"Q4 big-ticket rows: {int(count)} records "
          f"({rows.nbytes / 1e3:.1f} kB back vs {table_mb:.1f} MB table; "
          f"{st.reduction_factor:.0f}x reduction)")

    # interpreter tier agrees (the safety-first execution mode)
    csd.nvm_cmd_bpf_run(q2, 0, tier=CsdTier.INTERP)
    check(int(csd.nvm_cmd_bpf_result()) == refunds, "the interp tier disagrees")
    print("interp tier agrees with JIT tier — verified end to end")


if __name__ == "__main__":
    main()
