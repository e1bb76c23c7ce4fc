"""Per-tenant admission control and serving statistics.

The port of ``repro.gateway.admission``, copied as it is (pure Python).

A multi-tenant gateway's first job is to not let one tenant starve the
rest.  Admission here is a classic token bucket per tenant — ``rate``
queries/second refilling continuously up to ``burst`` — checked *before*
a query touches an artifact's queue, so a throttled tenant is rejected
with a ``retry_after`` hint instead of occupying bounded queue slots the
compliant tenants need (the queues themselves, and deadline propagation
through them, live in ``repro_torch.query.server``).

The same layer is the gateway's measurement point: every admitted query
is recorded per-tenant *and* per-artifact into fixed-size sliding
windows, and :meth:`AdmissionController.stats` folds them into one tree —
latency percentiles, windowed throughput, batch occupancy for fold-in
queries, admission/rejection/error counts — alongside the per-artifact
``QueryServer`` counters the registry contributes.

Costs are per-document for PREDICT (a 64-doc batch spends 64 tokens) and
1 for artifact-direct statistical queries, so the bucket meters actual
work, not statement count.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Optional

__all__ = ["TokenBucket", "TenantQuota", "QuotaExceededError",
           "AdmissionController"]


class QuotaExceededError(RuntimeError):
    """Tenant over its token bucket; ``retry_after`` says when to come
    back (seconds until the bucket can cover the request's cost)."""

    def __init__(self, tenant: str, retry_after: float, cost: float):
        self.tenant, self.retry_after, self.cost = tenant, retry_after, cost
        super().__init__(
            f"tenant {tenant!r} over quota (cost {cost:g}); "
            f"retry after {retry_after:.3f}s")


class TokenBucket:
    """Continuous-refill token bucket.  ``try_acquire(n)`` returns 0.0 and
    debits on success, else the seconds until ``n`` tokens will exist (no
    debit).  Injectable ``clock`` keeps the tests off the wall clock."""

    def __init__(self, rate: float, burst: float, clock=time.monotonic):
        if rate <= 0 or burst <= 0:
            raise ValueError(f"rate and burst must be > 0, "
                             f"got rate={rate} burst={burst}")
        self.rate, self.burst, self._clock = float(rate), float(burst), clock
        self._tokens = float(burst)
        self._stamp = clock()
        self._lock = threading.Lock()

    def try_acquire(self, cost: float = 1.0) -> float:
        if cost <= 0:
            raise ValueError(f"cost must be > 0, got {cost}")
        with self._lock:
            now = self._clock()
            self._tokens = min(self.burst,
                               self._tokens + (now - self._stamp) * self.rate)
            self._stamp = now
            if self._tokens >= cost - 1e-9:    # float refill drift tolerance
                self._tokens = max(0.0, self._tokens - cost)
                return 0.0
            if cost > self.burst:
                # can never be satisfied in one shot; report one full refill
                return self.burst / self.rate
            return (cost - self._tokens) / self.rate


@dataclasses.dataclass(frozen=True)
class TenantQuota:
    """``rate`` tokens/second refilling to ``burst``; PREDICT costs one
    token per document, artifact-direct queries cost 1."""
    rate: float = 100.0
    burst: float = 200.0


class _Window:
    """Fixed-size sliding window of (monotonic stamp, latency, batch_docs)
    plus monotone counters.  Mutated only under the controller lock."""

    __slots__ = ("samples", "served", "rejected", "errors")

    def __init__(self, window: int):
        self.samples = deque(maxlen=window)
        self.served = 0
        self.rejected = 0
        self.errors = 0

    def snapshot(self, now: float) -> dict:
        lats = sorted(s[1] for s in self.samples)
        n = len(lats)
        span = max(now - self.samples[0][0], 1e-9) if n else 0.0
        occ = [s[2] for s in self.samples if s[2] is not None]
        return {
            "served": self.served, "rejected": self.rejected,
            "errors": self.errors, "window": n,
            "throughput_qps": (n / span) if n else 0.0,
            "latency_p50_ms": _pct(lats, 0.50) * 1e3,
            "latency_p95_ms": _pct(lats, 0.95) * 1e3,
            "latency_p99_ms": _pct(lats, 0.99) * 1e3,
            "batch_occupancy": (sum(occ) / len(occ)) if occ else None,
        }


def _pct(sorted_vals: list, q: float) -> float:
    if not sorted_vals:
        return 0.0
    i = min(len(sorted_vals) - 1, int(q * len(sorted_vals)))
    return sorted_vals[i]


class AdmissionController:
    """Token-bucket admission plus windowed per-tenant / per-artifact
    accounting.

    Unknown tenants get ``default_quota`` (a fresh bucket each); pass
    ``default_quota=None`` to reject tenants that were never
    :meth:`set_quota`-ed (closed gateway)."""

    def __init__(self, default_quota: Optional[TenantQuota] = TenantQuota(),
                 stats_window: int = 2048, clock=time.monotonic):
        self.default_quota = default_quota
        self._window = int(stats_window)
        self._clock = clock
        self._lock = threading.Lock()
        self._buckets: dict[str, TokenBucket] = {}
        self._tenants: dict[str, _Window] = {}
        self._artifacts: dict[str, _Window] = {}

    # -- quota management --------------------------------------------------

    def set_quota(self, tenant: str, quota: TenantQuota) -> None:
        """Install/replace a tenant's quota (bucket restarts full)."""
        with self._lock:
            self._buckets[tenant] = TokenBucket(quota.rate, quota.burst,
                                                clock=self._clock)

    # -- the gate ----------------------------------------------------------

    def admit(self, tenant: str, cost: float = 1.0) -> None:
        """Debit ``cost`` from the tenant's bucket or raise
        :class:`QuotaExceededError` (recorded as a rejection)."""
        with self._lock:
            bucket = self._buckets.get(tenant)
            if bucket is None:
                if self.default_quota is None:
                    self._tenant_window(tenant).rejected += 1
                    raise QuotaExceededError(tenant, float("inf"), cost)
                bucket = TokenBucket(self.default_quota.rate,
                                     self.default_quota.burst,
                                     clock=self._clock)
                self._buckets[tenant] = bucket
        # bucket has its own lock; don't hold ours across the debit
        retry = bucket.try_acquire(cost)
        if retry > 0.0:
            with self._lock:
                self._tenant_window(tenant).rejected += 1
            raise QuotaExceededError(tenant, retry, cost)

    # -- accounting --------------------------------------------------------

    def record(self, tenant: str, artifact: Optional[str],
               latency_s: float, ok: bool = True,
               batch_docs: Optional[float] = None) -> None:
        """Account one admitted query against both windows."""
        now = self._clock()
        with self._lock:
            for win in (self._tenant_window(tenant),
                        self._artifact_window(artifact)):
                if win is None:
                    continue
                if ok:
                    win.samples.append((now, latency_s, batch_docs))
                    win.served += 1
                else:
                    win.errors += 1

    def _tenant_window(self, tenant: str) -> _Window:
        win = self._tenants.get(tenant)
        if win is None:
            win = self._tenants[tenant] = _Window(self._window)
        return win

    def _artifact_window(self, artifact: Optional[str]):
        if artifact is None:
            return None
        win = self._artifacts.get(artifact)
        if win is None:
            win = self._artifacts[artifact] = _Window(self._window)
        return win

    # -- observability -----------------------------------------------------

    def stats(self) -> dict:
        """One tree: ``{"tenants": {...}, "artifacts": {...}}`` of window
        snapshots (percentile latencies, windowed qps, occupancy,
        served/rejected/error counts)."""
        now = self._clock()
        with self._lock:
            return {
                "tenants": {t: w.snapshot(now)
                            for t, w in sorted(self._tenants.items())},
                "artifacts": {a: w.snapshot(now)
                              for a, w in sorted(self._artifacts.items())},
            }
