"""CSD array: multi-device striping + NVMe-style offload scheduling.

The subsystem the paper defers as future work — asynchronous execution and
multi-device operation — built on the repo's single-device primitives:

  * :mod:`repro_torch.array.striping`  — ``StripedZoneArray``: N ZNS devices as one
    logical zoned address space (``ZonedDevice`` drop-in, so every existing
    consumer works unchanged) with selectable redundancy: ``raid0``
    striping, ``raid1`` mirror pairs (round-robin reads, survivor redirect),
    or ``xor`` rotating parity (degraded reads reconstruct a dead member's
    chunks from the surviving row members on the completion ring);
  * :mod:`repro_torch.array.queues`    — NVMe-style per-tenant submission/completion
    queue pairs with depth limits, backpressure, and weighted round-robin
    arbitration;
  * :mod:`repro_torch.array.scheduler` — ``OffloadScheduler``: verify once,
    read every member run up front, one array-wide batched call per group
    on the compute ``device`` (the hand-written batched CUDA kernel on the
    kernel tier, each member run one copy to the card), an order-preserving
    program-aware combiner, aggregated ``ArrayOffloadStats``;
  * :mod:`repro_torch.array.rebuild`   — ``ArrayManager``: hot spares, online
    rebuild-to-spare on a metered ``"rebuild"`` tenant with per-zone
    cutover, background parity/mirror scrub, and automatic spare promotion
    off the alert engine's ``member_degraded`` incidents.
"""
from repro_torch.array.striping import (
    LogicalZone,
    REDUNDANCY_MODES,
    StripeChunk,
    StripedZoneArray,
)
from repro_torch.array.queues import (
    Completion,
    CompletionQueue,
    OffloadCommand,
    QueueFullError,
    QueuePair,
    SubmissionQueue,
    WeightedRoundRobinArbiter,
)
from repro_torch.array.scheduler import (
    ArrayOffloadError,
    ArrayOffloadStats,
    OffloadScheduler,
)
from repro_torch.array.rebuild import ArrayManager, RebuildError

__all__ = [
    "StripedZoneArray", "LogicalZone", "StripeChunk", "REDUNDANCY_MODES",
    "SubmissionQueue", "CompletionQueue", "QueuePair", "QueueFullError",
    "OffloadCommand", "Completion", "WeightedRoundRobinArbiter",
    "OffloadScheduler", "ArrayOffloadStats", "ArrayOffloadError",
    "ArrayManager", "RebuildError",
]
