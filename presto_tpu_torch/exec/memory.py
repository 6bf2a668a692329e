"""Memory-management hierarchy: pools, revocation, cluster-level kill.

The port's copy of presto_tpu/exec/memory.py (reference roles:
MemoryPool.java, MemoryRevokingScheduler.java:60 and
ClusterMemoryManager.java:106), with the same classes, rules and
messages:
- `MemoryPool` (:61): per-query reservations against one budget; a
  reservation that would cross `revoke_threshold` first runs the
  revocation hooks, largest reservations first (spill-before-fail);
- `ClusterMemoryManager` (:164): over the pools, kills the biggest query
  when the cluster budget is exceeded;
- `ExceededMemoryLimitError` (:48).

Reservations are the executor's plan footprints (exec/executor.py: each
node's output capacity times its row bytes, taken as the node runs).
The JAX module's `obs.metrics` gauges and counters are left out: the
port has no observability layer yet. `revocations`, `revoked_bytes` and
`kills` count the same events on the objects themselves.
"""

import threading
from typing import Callable, Dict, List, Optional


class ExceededMemoryLimitError(RuntimeError):
    """PrestoException(EXCEEDED_GLOBAL_MEMORY_LIMIT) analog."""

    def __init__(self, query_id: str, reserved: int, budget: int,
                 killed_by: str = "node"):
        self.query_id = query_id
        self.reserved = reserved
        self.budget = budget
        super().__init__(
            f"Query {query_id} exceeded {killed_by} memory limit: "
            f"reserved {reserved} bytes, budget {budget} bytes")


class MemoryPool:
    """Per-node pool: queries reserve/free bytes against one budget.

    `revoke_hook(query_id, bytes_needed)` is consulted when a
    reservation would cross `revoke_threshold` (fraction of budget):
    it should spill revocable state and return the bytes it freed —
    the MemoryRevokingScheduler contract."""

    def __init__(self, budget_bytes: int,
                 revoke_threshold: float = 0.8):
        self.budget = int(budget_bytes)
        self.revoke_threshold = revoke_threshold
        self._lock = threading.Lock()
        self._by_query: Dict[str, int] = {}
        self._revoke_hooks: List[Callable[[str, int], int]] = []
        self.revocations = 0            # observability counters
        self.revoked_bytes = 0

    @property
    def reserved(self) -> int:
        with self._lock:
            return sum(self._by_query.values())

    def query_reserved(self, query_id: str) -> int:
        """Bytes reserved for a query. Workers key reservations by task
        id (`{qid}.{stage}.{...}`), so a query's total is the exact key
        plus every dotted-prefix task key."""
        pfx = query_id + "."
        with self._lock:
            return sum(b for k, b in self._by_query.items()
                       if k == query_id or k.startswith(pfx))

    def add_revoke_hook(self, hook: Callable[[str, int], int]) -> None:
        self._revoke_hooks.append(hook)

    def reserve(self, query_id: str, nbytes: int) -> None:
        """Reserve or raise ExceededMemoryLimitError for THIS query.
        Crossing the revoke threshold first runs the revocation hooks
        (largest-reservation queries first — spill-before-fail)."""
        nbytes = int(nbytes)
        with self._lock:
            total = sum(self._by_query.values())
        if total + nbytes > self.budget * self.revoke_threshold:
            self._try_revoke(total + nbytes
                             - int(self.budget * self.revoke_threshold))
        with self._lock:
            total = sum(self._by_query.values())
            if total + nbytes > self.budget:
                raise ExceededMemoryLimitError(
                    query_id,
                    self._by_query.get(query_id, 0) + nbytes,
                    self.budget)
            self._by_query[query_id] = \
                self._by_query.get(query_id, 0) + nbytes

    def _try_revoke(self, need: int) -> int:
        freed = 0
        # biggest reservations revoke first (MemoryRevokingScheduler's
        # TaskRevocableMemoryComparator order)
        with self._lock:
            order = sorted(self._by_query, key=self._by_query.get,
                           reverse=True)
        for qid in order:
            if freed >= need:
                break
            for hook in self._revoke_hooks:
                got = int(hook(qid, need - freed) or 0)
                if got > 0:
                    freed += got
                    self.revocations += 1
                    self.revoked_bytes += got
                    with self._lock:
                        self._by_query[qid] = max(
                            0, self._by_query.get(qid, 0) - got)
        return freed

    def free(self, query_id: str, nbytes: Optional[int] = None) -> None:
        pfx = query_id + "."
        with self._lock:
            if nbytes is None:
                # full release drops the query's task-keyed
                # reservations too (worker pools key by task id)
                for k in [k for k in self._by_query
                          if k == query_id or k.startswith(pfx)]:
                    self._by_query.pop(k, None)
            else:
                cur = self._by_query.get(query_id, 0)
                nxt = max(0, cur - int(nbytes))
                if nxt:
                    self._by_query[query_id] = nxt
                else:
                    self._by_query.pop(query_id, None)


class ClusterMemoryManager:
    """Coordinator-side view over every worker pool. On sustained
    exhaustion, kills the single biggest query cluster-wide
    (ClusterMemoryManager.java:106 + LowMemoryKiller)."""

    def __init__(self, pools: List[MemoryPool],
                 budget_bytes: Optional[int] = None):
        """`budget_bytes` is the CLUSTER query-memory limit
        (query_max_memory) — independent of the per-node pool budgets,
        exactly like the reference's general-pool accounting; defaults
        to the sum of node budgets."""
        self.pools = pools
        self._budget = budget_bytes
        self.killed: Dict[str, ExceededMemoryLimitError] = {}
        self.kills = 0      # lifetime victim count (observability)

    def cluster_reserved(self) -> int:
        return sum(p.reserved for p in self.pools)

    def cluster_budget(self) -> int:
        if self._budget is not None:
            return self._budget
        return sum(p.budget for p in self.pools)

    def biggest_query(self) -> Optional[str]:
        totals: Dict[str, int] = {}
        for p in self.pools:
            with p._lock:
                for key, b in p._by_query.items():
                    # task-keyed worker reservations roll up to the
                    # owning query (task id = `{qid}.{stage}.{...}`)
                    qid = key.split(".", 1)[0]
                    totals[qid] = totals.get(qid, 0) + b
        if not totals:
            return None
        return max(totals, key=totals.get)

    def maybe_kill(self) -> Optional[str]:
        """If the cluster is over budget, mark the biggest query killed
        and free its reservations everywhere. Returns the victim id."""
        if self.cluster_reserved() <= self.cluster_budget():
            return None
        victim = self.biggest_query()
        if victim is None:
            return None
        reserved = sum(p.query_reserved(victim) for p in self.pools)
        self.killed[victim] = ExceededMemoryLimitError(
            victim, reserved, self.cluster_budget(), killed_by="cluster")
        for p in self.pools:
            p.free(victim)
        self.kills += 1
        return victim

    def check_killed(self, query_id: str) -> None:
        err = self.killed.pop(query_id, None)
        if err is not None:
            raise err
