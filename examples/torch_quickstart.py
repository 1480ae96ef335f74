"""Quickstart on the PyTorch port: the ZCSD workflow from the paper, end to end.

Creates an emulated ZNS device, fills a zone with random integers, then runs
the paper's Figure-2 filter offload on every execution tier of
``repro_torch`` — interpreter (uBPF analogue), eager PyTorch JIT, and the
hand-written CUDA zone-filter kernel (its plain PyTorch version on the CPU)
— printing each tier's runtime, JIT time, and data movement saved.

    PYTHONPATH=src python examples/torch_quickstart.py                 # the card
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu
"""
import argparse

import numpy as np

from repro_torch.core import CsdTier, NvmCsd, filter_count, histogram
from repro_torch.zns import ZonedDevice

RAND_MAX = 2**31 - 1


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="torch device of the offload tiers")
    args = ap.parse_args()

    # 1. an emulated ZNS SSD: 4 zones x 16 MiB, 4 KiB blocks
    dev = ZonedDevice(num_zones=4, zone_bytes=16 * 1024 * 1024,
                      block_bytes=4096)

    # 2. fill zone 0 with random integers (append-only writes)
    rng = np.random.default_rng(0)
    data = rng.integers(0, RAND_MAX, 4 * 1024 * 1024, dtype=np.int32)
    dev.zone_append(0, data)
    print(f"zone 0: wp={dev.zone(0).write_pointer} blocks, "
          f"state={dev.zone(0).state.value}")

    # 3. the offloaded program: count ints above RAND_MAX/2 (paper Fig. 2)
    program = filter_count("int32", "gt", RAND_MAX // 2)
    csd = NvmCsd(dev, device=args.device)

    expected = int((data > RAND_MAX // 2).sum())
    print(f"\nhost oracle: {expected} of {data.size} ints pass "
          f"({expected / data.size:.1%})\n")

    for tier in (CsdTier.INTERP, CsdTier.JIT, CsdTier.KERNEL):
        stats = csd.nvm_cmd_bpf_run(program, 0, tier=tier)
        result = int(csd.nvm_cmd_bpf_result())
        if result != expected:
            raise SystemExit(f"tier {tier} counted {result}, the host {expected}")
        print(f"tier={tier:7s} exec={stats.exec_seconds * 1e3:8.1f} ms  "
              f"jit={stats.jit_seconds * 1e3:6.1f} ms  "
              f"verified_insns={stats.insns_verified}  "
              f"saved={stats.movement_saved_bytes / 1e6:.1f} MB "
              f"({stats.reduction_factor:.0f}x reduction)")

    # 4. richer offloads: histogram without moving the zone
    hist = histogram("int32", 0, RAND_MAX, 16)
    csd.nvm_cmd_bpf_run(hist, 0, tier=CsdTier.JIT)
    print("\ndevice-side histogram (16 bins):",
          np.asarray(csd.nvm_cmd_bpf_result()))

    # 5. host-managed GC
    dev.reset_zone(0)
    print(f"\nafter reset: zone 0 state={dev.zone(0).state.value}, "
          f"resets={dev.stats['zone_resets']}")


if __name__ == "__main__":
    main()
