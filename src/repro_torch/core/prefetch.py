"""Read/compute overlap primitives for the offload hot path.

In-storage processing wins come from overlapping I/O with compute
(arXiv:2112.12415): while the execution tier crunches extent chunk ``k``, the
next chunk's device transfer should already be in flight. Three shapes of
that pattern live here:

  * :class:`RingReader` — the completion-ring shape and the default: a
    sequential page reader that keeps ``depth`` ``submit_read`` futures in
    flight on the device's reactor. No producer thread at all — the emulated
    transfer of page ``p+depth`` elapses on the zone's virtual clock while
    the interpreter crunches page ``p``, and ONE reactor thread drives every
    reader in the process;
  * :func:`prefetched` — a double-buffered iterator over work items whose
    ``fetch`` runs ``depth`` items ahead on an executor (generic: any fetch
    callable, not just ring-capable devices);
  * :class:`LookaheadReader` — the pre-ring thread-backed page reader kept
    for fetch callables that are not ring-backed; each instance burns a
    producer thread, which is exactly what the ring model removes.

Overlap only helps because the device models transfer time on per-zone
virtual-time queues rather than under its metadata lock (see
``ZonedDevice._claim_slot``) — against a device that serializes every
transfer, lookahead buys nothing.
"""
from __future__ import annotations

import concurrent.futures
import queue
import threading
import time
from collections import deque
from typing import TYPE_CHECKING, Callable, Iterator, Optional, Sequence, TypeVar

if TYPE_CHECKING:
    from repro_torch.zns.ring import IoFuture

__all__ = ["RingReader", "prefetched", "LookaheadReader"]

T = TypeVar("T")
R = TypeVar("R")


class RingReader:
    """Sequential ``read_page(p)`` drop-in backed by completion-ring futures.

    ``submit(p)`` must return an :class:`~repro_torch.zns.ring.IoFuture` (e.g. a
    bound ``device.submit_read``). The reader eagerly submits the first
    ``depth`` pages — claiming their slots on the zone's virtual-time queue —
    and tops the window back up as the consumer advances, so page ``p+depth``
    is always in flight while page ``p`` is being consumed.

    ``read_seconds`` accumulates the *emulated service time* of consumed
    pages (``IoFuture.service_seconds``) — the device-transfer time the
    overlap hides, same meaning the thread-backed reader reported.
    """

    def __init__(self, submit: Callable[[int], "IoFuture"], n_items: int, *,
                 depth: int = 2):
        self._submit = submit
        self.n_items = int(n_items)
        self._depth = max(int(depth), 1)
        self._futs: deque["IoFuture"] = deque()
        self._submitted = 0
        self._next = 0
        self.read_seconds = 0.0
        for _ in range(min(self._depth, self.n_items)):
            self._submit_next()

    def _submit_next(self) -> None:
        self._futs.append(self._submit(self._submitted))
        self._submitted += 1

    def __call__(self, p: int):
        if p != self._next:
            raise ValueError(
                f"RingReader is sequential: expected page {self._next}, "
                f"got {p}")
        self._next += 1
        fut = self._futs.popleft()
        if self._submitted < self.n_items:
            self._submit_next()
        value = fut.result()
        self.read_seconds += fut.service_seconds
        return value

    def close(self) -> None:
        """Abandoned in-flight futures just retire on the reactor (reads are
        side-effect-free); nothing to release."""
        self._futs.clear()

    def __enter__(self) -> "RingReader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def prefetched(
    items: Sequence[T],
    fetch: Callable[[T], R],
    *,
    executor: Optional[concurrent.futures.Executor] = None,
    depth: int = 2,
) -> Iterator[R]:
    """Yield ``fetch(item)`` for each item in order, keeping up to ``depth``
    fetches in flight on ``executor`` while the caller consumes earlier
    results. With no executor (or depth < 1) degrades to sequential fetching.

    The first ``depth`` fetches are submitted EAGERLY (at call time, not at
    the first ``next()``), so device reads start while the caller is still
    setting up — e.g. paying a compile-cache miss. Abandoning the iterator
    early leaves in-flight fetches to complete on the executor (reads are
    side-effect-free); exceptions from ``fetch`` surface at the
    corresponding ``next()``.
    """
    items = list(items)
    if executor is None or depth < 1 or len(items) <= 1:
        def _sequential() -> Iterator[R]:
            for it in items:
                yield fetch(it)
        return _sequential()

    futs: deque = deque(executor.submit(fetch, it) for it in items[:depth])

    def _overlapped() -> Iterator[R]:
        for j in range(len(items)):
            value = futs.popleft().result()
            nxt = j + depth
            if nxt < len(items):
                futs.append(executor.submit(fetch, items[nxt]))
            yield value

    return _overlapped()


class LookaheadReader:
    """Sequential ``read_page(p)`` drop-in that streams pages through a
    bounded lookahead queue filled by a background producer thread.

    The interp tier consumes pages strictly in order, so the producer simply
    runs ``fetch(0..n_items)`` ahead of the consumer, at most ``depth`` pages
    in flight. ``read_seconds`` accumulates the producer's time inside
    ``fetch`` — the device transfer time the overlap hides.
    """

    def __init__(self, fetch: Callable[[int], R], n_items: int, *,
                 depth: int = 2):
        self._fetch = fetch
        self.n_items = int(n_items)
        self._q: queue.Queue = queue.Queue(maxsize=max(depth, 1))
        self._stop = threading.Event()
        self._next = 0
        self.read_seconds = 0.0
        self._thread = threading.Thread(
            target=self._produce, name="page-lookahead", daemon=True)
        self._thread.start()

    def _produce(self) -> None:
        for p in range(self.n_items):
            if self._stop.is_set():
                return
            try:
                t0 = time.perf_counter()
                item = (p, self._fetch(p), None)
                self.read_seconds += time.perf_counter() - t0
            except BaseException as e:  # delivered at the consumer's read
                item = (p, None, e)
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=0.05)
                    break
                except queue.Full:
                    continue
            if item[2] is not None:
                return

    def __call__(self, p: int) -> R:
        if p != self._next:
            raise ValueError(
                f"LookaheadReader is sequential: expected page {self._next}, "
                f"got {p}")
        self._next += 1
        idx, value, err = self._q.get()
        assert idx == p
        if err is not None:
            raise err
        return value

    def close(self) -> None:
        """Release the producer (safe after partial consumption)."""
        self._stop.set()
        while True:  # unblock a producer waiting on a full queue
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        self._thread.join(timeout=5.0)

    def __enter__(self) -> "LookaheadReader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
