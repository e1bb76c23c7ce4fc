"""The multi-tenant serving gateway: QL in, routed answers out.

The port of ``repro.gateway.gateway``; ``Gateway(device=)`` names where
the artifacts' fold-ins run (``None`` means ``"cuda"``).

:class:`Gateway` composes the pieces of this package into one serving
front door:

- ``ql.parse`` turns statement text into a logical plan,
- :class:`~repro_torch.gateway.admission.AdmissionController` charges the
  tenant's token bucket (per *document* for PREDICT) before any artifact
  work happens,
- :class:`~repro_torch.gateway.registry.ArtifactRegistry` routes the plan's
  artifact id to a live posterior + fold-in + query server,
- ``plan.execute`` / ``plan.explain`` run or render it, sharing one
  route helper so ``EXPLAIN``'s stated route is the executed route.

::

    with Gateway(device="cuda") as gw:
        gw.register("lda-v7", posterior)
        r = gw.query("TOPICS OF phi TOP 5", tenant="alice")
        r.value["indices"], r.route, r.error_bound
        print(gw.explain("PREDICT LL FOR DOCS $batch",
                         params={"batch": docs}))
        gw.stats()["tenants"]["alice"]["latency_p95_ms"]

Every answer is a :class:`~repro_torch.gateway.plan.GatewayResult` carrying the
artifact version that served it and, for compacted artifacts, the
measured ``error_bound``.
"""

from __future__ import annotations

import time
from typing import Optional

from ..query.foldin import FoldInConfig
from . import plan as planner
from .admission import AdmissionController, TenantQuota
from .plan import GatewayResult
from .ql import parse, parse_script
from .registry import ArtifactRegistry

__all__ = ["Gateway"]


class Gateway:
    """One serving endpoint over many artifacts and many tenants."""

    def __init__(self, foldin_config: FoldInConfig = None,
                 default_quota: Optional[TenantQuota] = TenantQuota(),
                 stats_window: int = 2048, device=None, **server_defaults):
        self.registry = ArtifactRegistry(foldin_config=foldin_config,
                                         server_defaults=server_defaults,
                                         device=device)
        self.admission = AdmissionController(default_quota=default_quota,
                                             stats_window=stats_window)

    # -- artifact lifecycle (delegates; see registry.py) -------------------

    def register(self, artifact_id: str, posterior, *, version: str = "v0",
                 model=None, **server_kwargs):
        return self.registry.register(artifact_id, posterior,
                                      version=version, model=model,
                                      **server_kwargs)

    def swap(self, artifact_id: str, posterior, version: str = None) -> str:
        return self.registry.swap(artifact_id, posterior, version)

    def retire(self, artifact_id: str) -> None:
        self.registry.retire(artifact_id)

    def stop(self) -> None:
        self.registry.stop()

    def set_quota(self, tenant: str, quota: TenantQuota) -> None:
        self.admission.set_quota(tenant, quota)

    def __enter__(self) -> "Gateway":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- the query edge ----------------------------------------------------

    def query(self, text, params: dict = None, tenant: str = "default",
              timeout_s: float = None) -> GatewayResult:
        """Run one statement (text or a pre-parsed plan) for ``tenant``.

        Admission happens before routing — a throttled tenant costs the
        gateway a token-bucket read, nothing else.  ``timeout_s`` becomes
        the request deadline and travels with queued PREDICT work.
        Raises :class:`~repro_torch.gateway.admission.QuotaExceededError`,
        :class:`~repro_torch.gateway.registry.UnknownArtifactError`, or
        whatever the execution raises (recorded as a tenant error)."""
        q = parse(text) if isinstance(text, str) else text
        if q.kind == "show":
            value = ({"artifacts": self.registry.describe()}
                     if q.what == "artifacts" else {"stats": self.stats()})
            return GatewayResult(kind="show", artifact=None, version=None,
                                 route=f"gateway.{q.what} [introspection]",
                                 value=value, tenant=tenant)
        inner = q.inner if q.kind == "explain" else q
        self.admission.admit(tenant, self._cost(inner, params))
        entry = self.registry.get(inner.artifact)
        deadline = time.time() + timeout_s if timeout_s is not None else None
        t0 = time.perf_counter()
        try:
            if q.kind == "explain":
                bindings = self._bindings(inner, params)
                result = GatewayResult(
                    kind="explain", artifact=entry.artifact_id,
                    version=entry.version,
                    route=planner.route_of(inner, entry,
                                           payload_bindings=bindings),
                    value={"text": planner.explain(q, entry, params)},
                    error_bound=getattr(entry.posterior, "error_bound",
                                        None))
            else:
                result = planner.execute(q, entry, params, deadline)
        except Exception:
            self.admission.record(tenant, entry.artifact_id,
                                  time.perf_counter() - t0, ok=False)
            raise
        result.latency_s = time.perf_counter() - t0
        result.tenant = tenant
        self.admission.record(
            tenant, entry.artifact_id, result.latency_s, ok=True,
            batch_docs=result.value.get("batch_docs"))
        return result

    def run_script(self, text: str, params: dict = None,
                   tenant: str = "default",
                   timeout_s: float = None) -> list:
        """Run a ``;``-separated script; returns one result per
        statement, in order (fails fast on the first error)."""
        return [self.query(q, params, tenant, timeout_s)
                for q in parse_script(text)]

    def explain(self, text, params: dict = None) -> str:
        """Render a statement's plan without admission or execution (the
        DBA path; ``query("EXPLAIN ...")`` is the metered tenant path)."""
        q = parse(text) if isinstance(text, str) else text
        inner = q.inner if q.kind == "explain" else q
        if inner.kind == "show":
            raise ValueError("SHOW statements have no plan to explain")
        return planner.explain(inner, self.registry.get(inner.artifact),
                               params)

    # -- observability -----------------------------------------------------

    def stats(self) -> dict:
        """One tree: per-tenant admission/latency windows and, per
        artifact, the admission window merged with the underlying
        ``QueryServer`` counters (queue, batches, built buckets,
        evictions, swaps)."""
        adm = self.admission.stats()
        servers = self.registry.stats()
        artifacts = {}
        for aid in sorted(set(adm["artifacts"]) | set(servers)):
            node = dict(adm["artifacts"].get(aid, {}))
            if aid in servers:
                node["server"] = servers[aid]
            artifacts[aid] = node
        return {"tenants": adm["tenants"], "artifacts": artifacts}

    # -- internals ---------------------------------------------------------

    @staticmethod
    def _cost(inner, params: dict) -> float:
        """PREDICT charges per document; everything else charges 1."""
        if inner.kind != "predict" or not params \
                or inner.payload not in params:
            return 1.0
        p = params[inner.payload]
        if isinstance(p, dict):
            if p.get("lengths") is not None:
                return float(max(len(p["lengths"]), 1))
            seg = p.get("segment_ids")
            if seg is not None and len(seg):
                import numpy as np
                return float(int(np.max(seg)) + 1)
        return 1.0

    @staticmethod
    def _bindings(inner, params: dict) -> bool:
        if inner.kind != "predict" or not params \
                or inner.payload not in params:
            return False
        p = params[inner.payload]
        return isinstance(p, dict) and bool(p.get("bindings"))
