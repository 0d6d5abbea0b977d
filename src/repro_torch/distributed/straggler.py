"""Straggler mitigation for the serving tier (counterpart of
``repro/distributed/straggler.py``; host side, no tensors).

  * ``DeadlineReissue``: speculative re-dispatch. A batch that has not
    returned within ``deadline = k x EWMA(latency)`` is re-dispatched onto
    the least-loaded replica of its shard; the first response wins
    (results are content-addressed by batch id, duplicates dropped).
  * ``EwmaTracker``: the latency estimator feeding the deadline.

Both take their clock as an argument (``DeadlineReissue(clock=...)``): the
serving tier passes its stream clock, and tests pass a scripted one.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable

__all__ = ["EwmaTracker", "DeadlineReissue", "HedgeConfig"]


@dataclasses.dataclass(frozen=True)
class HedgeConfig:
    """Hedged-dispatch policy for the serving topology's scatter path
    (``core.topology.ServingTopology(hedge=...)``): a flush whose shard has
    not answered within ``k`` x the shard's EWMA latency is speculatively
    re-dispatched to the least-loaded replica of that shard; the first
    response wins and duplicates are dropped. ``max_reissue`` bounds the
    duplicated work per flush; ``alpha`` is the EWMA smoothing factor."""
    k: float = 3.0
    max_reissue: int = 1
    alpha: float = 0.2

    def __post_init__(self):
        if not self.k > 0:
            raise ValueError(f"deadline multiplier k must be > 0, got {self.k}")
        if self.max_reissue < 1:
            raise ValueError(
                f"max_reissue must be >= 1, got {self.max_reissue}")
        if not 0 < self.alpha <= 1:
            raise ValueError(f"alpha must be in (0, 1], got {self.alpha}")


@dataclasses.dataclass
class EwmaTracker:
    alpha: float = 0.2
    value: float | None = None

    def update(self, x: float) -> float:
        self.value = x if self.value is None else \
            self.alpha * x + (1 - self.alpha) * self.value
        return self.value


@dataclasses.dataclass
class DeadlineReissue:
    """Tracks in-flight batches; `poll` returns batch ids past deadline.

    k: deadline multiplier over the EWMA latency (3.0 ≈ p99.7 for
    exponential-ish tails). max_reissue bounds duplicated work.
    """
    k: float = 3.0
    max_reissue: int = 1
    clock: Callable[[], float] = time.monotonic
    tracker: EwmaTracker = dataclasses.field(default_factory=EwmaTracker)
    _inflight: dict = dataclasses.field(default_factory=dict)
    _reissues: dict = dataclasses.field(default_factory=dict)
    _done: set = dataclasses.field(default_factory=set)
    reissued_total: int = 0
    duplicate_results: int = 0

    def dispatch(self, batch_id):
        self._inflight.setdefault(batch_id, self.clock())

    def complete(self, batch_id) -> bool:
        """Returns True if this is the FIRST completion (result usable)."""
        if batch_id in self._done:
            self.duplicate_results += 1
            return False
        t0 = self._inflight.pop(batch_id, None)
        self._done.add(batch_id)
        if t0 is not None:
            self.tracker.update(self.clock() - t0)
        return True

    def next_deadline(self) -> float:
        """Earliest instant an in-flight batch becomes overdue (inf when
        nothing reissuable is in flight) — lets an event loop nap until a
        reissue could fire instead of polling. While the latency estimate
        is UNSEEDED the deadline cannot be computed, so the oldest dispatch
        time (already past) is returned: the loop must keep polling rather
        than block behind the very straggler it would rescue."""
        ts = [t0 for bid, t0 in self._inflight.items()
              if self._reissues.get(bid, 0) < self.max_reissue]
        if not ts:
            return math.inf
        if self.tracker.value is None:
            return min(ts)
        return min(ts) + self.k * self.tracker.value

    def poll(self) -> list:
        """Batch ids overdue for speculative re-dispatch."""
        if self.tracker.value is None:
            return []
        deadline = self.k * self.tracker.value
        now = self.clock()
        out = []
        # `now >= t0 + deadline` (NOT `now - t0 >= deadline`): callers wake
        # at exactly `t0 + deadline` and the subtraction form can round one
        # ulp below the threshold, silently skipping the reissue
        for bid, t0 in self._inflight.items():
            if now >= t0 + deadline and \
                    self._reissues.get(bid, 0) < self.max_reissue:
                self._reissues[bid] = self._reissues.get(bid, 0) + 1
                self.reissued_total += 1
                out.append(bid)
        return out
