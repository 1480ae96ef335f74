"""Retry/timeout/backoff engine for ring-delivered transient errors.

The device submit paths stay asynchronous under faults: a retry is NOT a
blocking loop around ``result()`` but a chain of completion callbacks.
:func:`drive_retries` owns one caller-visible aggregate future and, behind
it, launches up to ``max_attempts`` device-level attempt futures; each
attempt's error completion either resolves the aggregate or schedules the
next attempt after an exponential-backoff delay. The backoff timer is
itself an :class:`~repro_torch.zns.ring.IoFuture` parked on the reactor heap —
backoff elapses in the same emulated clock as every other completion, and
jitter comes from the seeded injector hash, never from wall-clock entropy,
so retry schedules replay exactly.

Per-attempt timeouts use the same timer primitive: a completion callback
and a timeout timer race for a once-only latch; whichever settles the
attempt first wins, and the loser's late firing is ignored. That latch is
what rescues *hung* commands (attempt futures that will never retire).
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Callable, Optional

from repro_torch.faults.errors import IoTimeoutError, TransientIOError

if False:  # typing only — a module-level import would close a cycle:
    # repro_torch.faults -> retry -> repro_torch.zns (package) -> device -> repro_torch.faults
    from repro_torch.zns.ring import IoFuture, IoReactor

__all__ = ["RetryPolicy", "schedule_timer", "drive_retries"]


@dataclass(frozen=True)
class RetryPolicy:
    """Bounded-attempt exponential backoff with seeded jitter.

    ``timeout_s`` is the per-attempt patience: an attempt whose completion
    has not retired within it is abandoned (counted as a timeout) and the
    budget permitting, retried. ``None`` disables timeouts — a hung command
    then surfaces only through the caller's own ``result(timeout=)``.
    """

    max_attempts: int = 4
    backoff_base_s: float = 200e-6
    backoff_factor: float = 2.0
    jitter_frac: float = 0.25
    timeout_s: Optional[float] = None

    def backoff_s(self, attempt: int, u01: float) -> float:
        """Delay before attempt ``attempt + 1`` given a uniform jitter draw:
        ``base * factor**(attempt-1)``, spread +/- ``jitter_frac``."""
        base = self.backoff_base_s * (self.backoff_factor ** (attempt - 1))
        return base * (1.0 + self.jitter_frac * (2.0 * u01 - 1.0))


def schedule_timer(reactor: IoReactor, delay_s: float,
                   fn: Callable[[], None]) -> IoFuture:
    """Run ``fn()`` after ``delay_s`` on the reactor clock. The timer is a
    plain value-bearing IoFuture (op ``retry-timer``), so it rides the same
    deadline heap as data completions — zero or negative delays fire inline
    on the calling thread, like any already-due completion."""
    from repro_torch.zns.ring import IoFuture
    t = IoFuture(op="retry-timer")
    t._value = None
    t.add_done_callback(lambda _f: fn())
    return reactor.schedule(t, time.monotonic() + max(0.0, delay_s))


def drive_retries(agg: IoFuture, *, policy: RetryPolicy, reactor: IoReactor,
                  submit: Callable[[int], Optional[IoFuture]],
                  jitter01: Callable[[], float],
                  on_retry: Optional[Callable[[int, BaseException], None]] = None,
                  on_timeout: Optional[Callable[[int, BaseException], None]] = None,
                  on_exhausted: Optional[Callable[[int, BaseException], None]] = None,
                  timeout_error: Optional[Callable[[int], BaseException]] = None,
                  first: Optional[tuple] = None) -> IoFuture:
    """Resolve ``agg`` by driving up to ``policy.max_attempts`` submissions.

    ``submit(attempt)`` issues one device-level attempt and returns its
    future — or ``None`` for a hung command whose completion will never
    arrive (only the attempt timeout can rescue it). ``first=(fut,)`` hands
    in a pre-submitted attempt 1 (appends land their data effect under the
    device lock before the controller takes over); the one-element tuple
    keeps a ``None`` hung first attempt distinguishable from "not given".

    Success completes ``agg`` with the attempt's value. A retryable error
    (``TransientIOError.retryable``) with budget left schedules the next
    attempt after :meth:`RetryPolicy.backoff_s`; anything else — permanent
    error, torn append, exhausted budget — fails ``agg`` with the final
    error. The ``on_*`` hooks fire before the follow-up action, in attempt
    order, on whichever thread settled the attempt.
    """

    def launch(attempt: int, pre: Optional[tuple] = None) -> None:
        if pre is not None:
            fut = pre[0]
        else:
            try:
                fut = submit(attempt)
            except BaseException as e:   # submit-time (protocol) failure
                agg.fail(e)
                return

        settled = [False]
        latch = threading.Lock()

        def claim() -> bool:
            with latch:
                if settled[0]:
                    return False
                settled[0] = True
                return True

        def settle_error(err: BaseException, *, timed_out: bool) -> None:
            retryable = isinstance(err, TransientIOError) and err.retryable
            more = retryable and attempt < policy.max_attempts
            if timed_out and on_timeout is not None:
                on_timeout(attempt, err)
            elif not timed_out and more and on_retry is not None:
                on_retry(attempt, err)
            if more:
                delay = policy.backoff_s(attempt, jitter01())
                if delay > 0:
                    schedule_timer(reactor, delay,
                                   lambda: launch(attempt + 1))
                else:
                    launch(attempt + 1)
                return
            if on_exhausted is not None:
                on_exhausted(attempt, err)
            agg.fail(err)

        def on_complete(f: IoFuture) -> None:
            if not claim():
                return            # the timeout timer already abandoned us
            if f._error is None:
                agg.complete(f._value)
            else:
                settle_error(f._error, timed_out=False)

        def fire_timeout() -> None:
            if not claim():
                return            # completion won the race
            if timeout_error is not None:
                err = timeout_error(attempt)
            else:
                err = IoTimeoutError(
                    f"attempt {attempt} exceeded "
                    f"timeout_s={policy.timeout_s}", attempt=attempt)
            settle_error(err, timed_out=True)

        if fut is None:
            # hung command: no completion will ever arrive, so without a
            # timeout budget the aggregate (deliberately) hangs too
            if policy.timeout_s is not None:
                schedule_timer(reactor, policy.timeout_s, fire_timeout)
            return
        if policy.timeout_s is not None and not fut.done():
            schedule_timer(reactor, policy.timeout_s, fire_timeout)
        fut.add_done_callback(on_complete)

    launch(1, first)
    return agg
