"""Seeded, fully deterministic fault injector for the emulated ZNS fleet.

A :class:`FaultInjector` is consulted by the device submit paths — once per
submission attempt, inside the same critical section that lands the data
effect — and answers with a :class:`FaultDecision`: inject nothing, a
retryable media-error completion, a virtual-time latency spike, a torn
append, or a hung (never-completing) command.

Determinism is the whole point: decisions are **pure functions** of
``(seed, fault key, op, per-(key, op) sequence number)`` via a
splitmix64-style hash, NOT draws from shared mutable RNG state. Two runs
with the same seed and the same per-device submission order replay the
*identical* fault schedule even when reactor threads interleave
differently across devices — each (key, op) stream advances its own
counter, so cross-device thread races cannot perturb another device's
draws. The array fan-out submits member transfers under the array lock in
plan order, so per-device submission order is itself deterministic.

``force`` schedules an exact fault at an exact sequence number (tests and
the crash harness script precise scenarios); ``schedule_log`` returns the
ordered list of injected faults per (key, op) — the replay transcript the
determinism tests compare across runs.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Optional

__all__ = ["FaultSpec", "FaultDecision", "FaultInjector"]

_MASK = (1 << 64) - 1


def _mix64(x: int) -> int:
    """splitmix64 finalizer: avalanche one 64-bit lane."""
    x = (x + 0x9E3779B97F4A7C15) & _MASK
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK
    return x ^ (x >> 31)


def _fold_str(s: str) -> int:
    """FNV-1a over a short string — stable across runs and processes
    (``hash()`` is salted per interpreter, so it would break replay)."""
    h = 0xCBF29CE484222325
    for ch in s.encode():
        h = ((h ^ ch) * 0x100000001B3) & _MASK
    return h


def _u01(seed: int, key: int, op: str, seq: int, salt: int) -> float:
    """Uniform float in [0, 1) as a pure function of the draw coordinates."""
    h = _mix64(seed ^ _mix64(key ^ _mix64(_fold_str(op) ^ _mix64(seq ^ salt))))
    return (h >> 11) * (1.0 / (1 << 53))


# per-fault-class salts: independent draws per class, so e.g. raising the
# media-error rate never shifts which submissions hang
_SALT_HANG = 0x68616E67
_SALT_TORN = 0x746F726E
_SALT_MEDIA = 0x6D656469
_SALT_SPIKE = 0x7370696B
_SALT_TORN_KEEP = 0x6B656570
_SALT_JITTER = 0x6A697474


@dataclass(frozen=True)
class FaultSpec:
    """Per-key fault rates (probabilities per submission attempt) and
    magnitudes. All default to zero — an attached injector with a default
    spec is a no-op."""

    read_error_rate: float = 0.0      # retryable media error on reads
    append_error_rate: float = 0.0    # retryable media error on appends
    latency_spike_rate: float = 0.0   # extra service time on the zone clock
    latency_spike_s: float = 0.002
    hang_rate: float = 0.0            # command whose completion never arrives
    torn_append_rate: float = 0.0     # partial landing + non-retryable error


@dataclass(frozen=True)
class FaultDecision:
    """One submission attempt's verdict. ``kind`` is ``None`` (healthy),
    ``"media"``, ``"hang"``, or ``"torn"``; ``extra_latency_s`` adds to the
    attempt's emulated service time; ``torn_keep`` is the fraction of the
    payload that lands before a torn append fails."""

    kind: Optional[str] = None
    extra_latency_s: float = 0.0
    torn_keep: float = 0.5


_NO_FAULT = FaultDecision()


class FaultInjector:
    """Deterministic fault source shared by any number of devices.

    ``key`` identifies the fault stream a device draws from — use a stable
    identity (the member index in an array), not the process-global device
    ordinal, so schedules replay across runs that construct devices in
    different orders. ``spec`` is the default rate card; ``per_key`` maps
    specific keys to their own :class:`FaultSpec` (e.g. one sick member).
    """

    def __init__(self, seed: int, spec: Optional[FaultSpec] = None, *,
                 per_key: Optional[dict] = None):
        self.seed = int(seed) & _MASK
        self.spec = spec if spec is not None else FaultSpec()
        self.per_key = dict(per_key or {})
        self._lock = threading.Lock()
        self._seq: dict[tuple, int] = {}        # (key, op) -> next seq
        self._forced: dict[tuple, FaultDecision] = {}   # (key, op, seq)
        self._log: dict[tuple, list] = {}       # (key, op) -> [(seq, kind)]
        # per-kind injection totals (host-visible; devices also count their
        # own faults_injected)
        self.injected: dict[str, int] = {"media": 0, "hang": 0, "torn": 0,
                                         "latency": 0}

    # ----------------------------------------------------------- wiring
    def spec_for(self, key) -> FaultSpec:
        return self.per_key.get(key, self.spec)

    def attach(self, device, key=None, *, policy=None) -> None:
        """Point ``device``'s submit paths at this injector under fault
        stream ``key`` (defaults to the device's ordinal); optionally set
        its :class:`~repro_torch.faults.retry.RetryPolicy` in the same breath."""
        device.fault_injector = self
        device.fault_key = key if key is not None else device.dev_ordinal
        if policy is not None:
            device.retry_policy = policy

    def attach_array(self, array, *, policy=None) -> None:
        """Attach every member of a striped array, keyed by member index —
        the stable identity that makes schedules replay across runs."""
        for i, d in enumerate(array.devices):
            self.attach(d, key=i, policy=policy)

    # --------------------------------------------------------- decisions
    def force(self, key, op: str, seq: int, kind: Optional[str], *,
              extra_latency_s: float = 0.0, torn_keep: float = 0.5) -> None:
        """Script an exact decision for the ``seq``-th ``op`` submission on
        ``key`` (0-based), overriding the hashed draw — precise scenarios
        for tests and the crash harness."""
        self._forced[(key, op, int(seq))] = FaultDecision(
            kind=kind, extra_latency_s=extra_latency_s, torn_keep=torn_keep)

    def decide(self, key, op: str, zone_id: int, nblocks: int, *,
               retry: bool = False) -> FaultDecision:
        """One submission attempt's fault verdict; advances the (key, op)
        sequence counter. ``retry=True`` marks a re-submission — a torn
        draw degrades to a plain media error there, because the original
        payload already landed in full (only the completion is re-run)."""
        with self._lock:
            sk = (key, op)
            seq = self._seq.get(sk, 0)
            self._seq[sk] = seq + 1
        d = self._forced.get((key, op, seq))
        if d is None:
            d = self._draw(key, op, seq)
        if d.kind == "torn" and (retry or op != "append" or nblocks < 2):
            # a tear needs >=2 blocks of fresh payload to be partial;
            # otherwise it is indistinguishable from a media error
            d = FaultDecision(kind="media",
                              extra_latency_s=d.extra_latency_s)
        if d.kind is not None or d.extra_latency_s:
            with self._lock:
                self._log.setdefault(sk, []).append(
                    (seq, d.kind or "latency"))
                self.injected[d.kind or "latency"] += 1
        return d

    def _draw(self, key, op: str, seq: int) -> FaultDecision:
        spec = self.spec_for(key)
        kseed = key if isinstance(key, int) else _fold_str(str(key))
        if spec.hang_rate and \
                _u01(self.seed, kseed, op, seq, _SALT_HANG) < spec.hang_rate:
            return FaultDecision(kind="hang")
        if op == "append" and spec.torn_append_rate and \
                _u01(self.seed, kseed, op, seq,
                     _SALT_TORN) < spec.torn_append_rate:
            keep = 0.25 + 0.5 * _u01(self.seed, kseed, op, seq,
                                     _SALT_TORN_KEEP)
            return FaultDecision(kind="torn", torn_keep=keep)
        rate = spec.read_error_rate if op == "read" else spec.append_error_rate
        if rate and _u01(self.seed, kseed, op, seq, _SALT_MEDIA) < rate:
            return FaultDecision(kind="media")
        if spec.latency_spike_rate and \
                _u01(self.seed, kseed, op, seq,
                     _SALT_SPIKE) < spec.latency_spike_rate:
            return FaultDecision(extra_latency_s=spec.latency_spike_s)
        return _NO_FAULT

    def jitter01(self, key, op: str) -> float:
        """Seeded uniform in [0, 1) for retry-backoff jitter; advances its
        own (key, op) counter, so jitter draws never perturb fault draws."""
        with self._lock:
            sk = (key, op, "jitter")
            seq = self._seq.get(sk, 0)
            self._seq[sk] = seq + 1
        kseed = key if isinstance(key, int) else _fold_str(str(key))
        return _u01(self.seed, kseed, op, seq, _SALT_JITTER)

    # ----------------------------------------------------------- reports
    def schedule_log(self) -> dict[tuple, list]:
        """Ordered injected-fault transcript: ``{(key, op): [(seq, kind),
        ...]}`` — byte-identical across two runs with the same seed and
        submission order (the determinism tests' witness)."""
        with self._lock:
            return {k: list(v) for k, v in self._log.items()}

    def __repr__(self) -> str:
        return (f"FaultInjector(seed={self.seed}, injected={self.injected})")
