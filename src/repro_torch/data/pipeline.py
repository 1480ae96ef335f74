"""Zone-backed training-data pipeline with ZCSD pushdown.

Training data lives on a :class:`~repro_torch.zns.ZonedDevice` as fixed-stride
records: ``[quality_score, token_0, ..., token_{T-1}]`` (int32). The pipeline
demonstrates the paper's thesis inside the training stack:

  * **pushdown filtering** — a verified offload Program
    (``FIELD(stride, 0); CMP_GE(min_quality); SELECT``) runs ON the device
    tier; only records that pass quality filtering cross to the host,
    and the per-epoch ``OffloadStats`` expose the data movement saved
    (the paper's headline statistic);
  * **pushdown statistics** — token histograms / quality quantiles computed
    device-side for curriculum decisions without moving the corpus;
  * **straggler mitigation** — N prefetch workers race batch reads; a backup
    fetch fires when a zone read exceeds the deadline (hedged requests), so
    one slow zone (device) cannot stall the step clock.

The port of :mod:`repro.data.pipeline`: the store and the loader are the
reference's numpy and threads; the pushdown runs on the port's ``NvmCsd``
or ``OffloadScheduler`` on ``device`` (the card unless the caller passes
``"cpu"``), and batches are host ``torch.int32`` tensors.
"""
from __future__ import annotations

import itertools
import queue
import threading
import time
from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np
import torch

from repro_torch.array import OffloadScheduler, StripedZoneArray
from repro_torch.core import CsdTier, NvmCsd, OffloadStats
from repro_torch.core.programs import Instruction, OpCode, Program
from repro_torch.telemetry.metrics import MetricsRegistry, StatsView
from repro_torch.zns import ZonedDevice

_STORE_SEQ = itertools.count()

__all__ = ["ZoneDataStore", "ZoneDataPipeline", "PrefetchLoader"]


class ZoneDataStore:
    """Fixed-stride int32 records appended into zones.

    The record stride is padded so records never straddle the device read
    granularity (a verifier requirement for FIELD projections): either the
    stride divides the page's element count, or it is a whole multiple of it
    (then the pipeline reads multiple pages per offload access).
    """

    def __init__(self, device: ZonedDevice | StripedZoneArray, seq_len: int):
        self.device = device
        self.seq_len = seq_len
        per_page = device.block_bytes // 4
        raw = seq_len + 1                   # [quality | tokens...]
        if raw <= per_page:
            stride = 1
            while stride < raw:
                stride *= 2                 # next power of two divides per_page
            stride = min(stride, per_page)
        else:
            stride = -(-raw // per_page) * per_page   # round up to whole pages
        self.stride = stride
        self.pages_per_record_unit = max(stride // per_page, 1)
        self.records_written = 0
        # store-level host-copy accounting: the record staging buffer
        # (quality column + stride padding) is a host-side copy the device
        # counters never see — the data-path analogue of the checkpoint
        # store's serialization accounting. Counters live on a private
        # per-store registry; `stats` keeps its dict shape as a live view,
        # and concurrent appenders increment atomically.
        self.metrics = MetricsRegistry(f"data{next(_STORE_SEQ)}")
        self._c_bytes_copied = self.metrics.counter("bytes_copied")
        self._c_bytes_viewed = self.metrics.counter("bytes_viewed")
        self.stats = StatsView({"bytes_copied": self._c_bytes_copied,
                                "bytes_viewed": self._c_bytes_viewed})

    def append_records(self, zone_id: int, tokens: np.ndarray,
                       quality: Optional[np.ndarray] = None) -> int:
        """tokens: [N, seq_len] int32; quality: [N] int32 (default 100)."""
        n = tokens.shape[0]
        if quality is None:
            quality = np.full((n,), 100, np.int32)
        recs = np.zeros((n, self.stride), np.int32)
        recs[:, 0] = quality.astype(np.int32)
        recs[:, 1 : 1 + self.seq_len] = tokens.astype(np.int32)
        # pad the append to whole blocks with sentinel quality -1 records
        per_block = self.device.block_bytes // 4
        flat = recs.reshape(-1)
        pad_elems = (-flat.size) % per_block
        if pad_elems:
            n_pad = -(-pad_elems // self.stride)
            pad = np.zeros((n_pad, self.stride), np.int32)
            pad[:, 0] = -1                  # never passes quality >= 0
            flat = np.concatenate([flat, pad.reshape(-1)])
        self._c_bytes_copied.inc(flat.nbytes)   # staging copy to device
        self.device.zone_append(zone_id, flat)
        self.records_written += n
        return n

    def records_in_zone(self, zone_id: int) -> int:
        z = self.device.zone(zone_id)
        return (z.write_pointer * self.device.block_bytes // 4) // self.stride


@dataclass
class PipelineStats:
    bytes_read_device: int = 0
    bytes_to_host: int = 0
    records_seen: int = 0
    records_kept: int = 0
    offloads: int = 0

    @property
    def movement_saved(self) -> int:
        return max(self.bytes_read_device - self.bytes_to_host, 0)


class ZoneDataPipeline:
    """Batch iterator with device-side quality pushdown."""

    def __init__(self, store: ZoneDataStore, *, batch: int,
                 min_quality: int = 0, tier: str = CsdTier.JIT,
                 select_capacity: Optional[int] = None, device="cuda"):
        self.store = store
        if isinstance(store.device, StripedZoneArray):
            # striped pushdown: the quality filter fans out across every
            # member device; only surviving records cross to the host
            self.csd = OffloadScheduler(
                store.device, default_tier=tier,
                pages_per_read=store.pages_per_record_unit, device=device)
        else:
            self.csd = NvmCsd(store.device, default_tier=tier,
                              pages_per_read=store.pages_per_record_unit,
                              device=device)
        self.batch = batch
        self.min_quality = min_quality
        self.stats = PipelineStats()
        self.select_capacity = select_capacity

    def _zone_records(self, zone_id: int) -> np.ndarray:
        """Two-phase pushdown, fully device-side:

        1. ``FIELD(stride,0); CMP_GE(q); RED_COUNT``  -> survivor count
           (8 bytes back — sizes the SELECT_REC capacity exactly);
        2. ``FIELD(stride,0); CMP_GE(q); SELECT_REC`` -> only the surviving
           records cross to the host.
        """
        stride = self.store.stride
        nrec = self.store.records_in_zone(zone_id)
        if nrec == 0:
            return np.zeros((0, stride), np.int32)
        base = (Instruction(OpCode.FIELD, (stride, 0)),
                Instruction(OpCode.CMP_GE, int(self.min_quality)))
        n_blocks = self.store.device.zone(zone_id).write_pointer

        count_prog = Program("int32", (*base, Instruction(OpCode.RED_COUNT)),
                             name="quality_count")
        st = self.csd.nvm_cmd_bpf_run(count_prog, zone_id, n_blocks=n_blocks)
        kept = int(self.csd.nvm_cmd_bpf_result())
        self.stats.offloads += 1
        self.stats.bytes_read_device += st.bytes_read

        cap = self.select_capacity or max(kept, 1)
        sel_prog = Program("int32", (*base, Instruction(OpCode.SELECT_REC)),
                           select_capacity=cap, name="quality_select_rec")
        st2 = self.csd.nvm_cmd_bpf_run(sel_prog, zone_id, n_blocks=n_blocks)
        records, total = self.csd.nvm_cmd_bpf_result()
        records = np.asarray(records)[: min(kept, cap)]
        self.stats.offloads += 1
        self.stats.bytes_read_device += st2.bytes_read
        self.stats.bytes_to_host += records.nbytes + 8
        self.stats.records_seen += nrec
        self.stats.records_kept += records.shape[0]
        assert int(total) == kept, "device count != select_rec count"
        return records

    def batches(self, zone_ids: list[int], *, epochs: int = 1,
                seed: int = 0) -> Iterator[dict]:
        """Yield training batches {tokens, labels} from the surviving
        records of the given zones, as host ``torch.int32`` tensors (the
        trainer moves them to its device, as with a ``DataLoader``)."""
        rng = np.random.default_rng(seed)
        for _ in range(epochs):
            pool = []
            for zid in zone_ids:
                recs = self._zone_records(zid)
                if recs.size:
                    pool.append(recs)
            if not pool:
                return
            recs = np.concatenate(pool, axis=0)
            order = rng.permutation(recs.shape[0])
            recs = recs[order]
            nb = recs.shape[0] // self.batch
            T = self.store.seq_len
            for i in range(nb):
                chunk = recs[i * self.batch : (i + 1) * self.batch, 1 : 1 + T]
                yield {
                    "tokens": torch.from_numpy(chunk[:, :-1].copy()),
                    "labels": torch.from_numpy(chunk[:, 1:].copy()),
                }

    def histogram(self, zone_id: int, bins: int = 64) -> np.ndarray:
        """Device-side token histogram (no corpus movement)."""
        from repro_torch.core.programs import histogram as hist_prog
        prog = hist_prog("int32", 0, 2**31 - 1, bins)
        self.csd.nvm_cmd_bpf_run(prog, zone_id)
        return np.asarray(self.csd.nvm_cmd_bpf_result())


class PrefetchLoader:
    """Hedged prefetching around any batch iterator.

    ``workers`` threads pull from the source iterator into a bounded queue.
    A consumer-side deadline triggers a *backup* fetch path: if the queue
    stays empty past ``hedge_seconds`` (a straggling zone read), the loader
    synchronously fetches from the iterator itself rather than waiting —
    bounding the step-time tail (hedged-request straggler mitigation).
    """

    def __init__(self, it: Iterator[dict], *, depth: int = 4,
                 hedge_seconds: float = 1.0):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._it = it
        self._lock = threading.Lock()
        self._done = False
        self.hedge_seconds = hedge_seconds
        self.hedged_fetches = 0
        self._thread = threading.Thread(target=self._fill, daemon=True)
        self._thread.start()

    def _next_upstream(self):
        with self._lock:
            return next(self._it, None)

    def _fill(self):
        while True:
            item = self._next_upstream()
            if item is None:
                self._done = True
                self._q.put(None)
                return
            self._q.put(item)

    def __iter__(self):
        return self

    def __next__(self):
        try:
            item = self._q.get(timeout=self.hedge_seconds)
        except queue.Empty:
            if self._done:
                raise StopIteration
            # straggler: hedge by fetching directly
            self.hedged_fetches += 1
            item = self._next_upstream()
        if item is None:
            raise StopIteration
        return item
