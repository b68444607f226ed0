"""Memory governance: query memory contexts, worker pools, and the
cluster memory manager.

The analog of the reference's memory subsystem
(core/trino-memory-context LocalMemoryContext/AggregatedMemoryContext,
MAIN/memory/MemoryPool.java and MAIN/memory/ClusterMemoryManager.java):

- ``MemoryContext`` — a node in the query → task → operator tree.
  Every executor allocation path reports through ``reserve(nbytes)`` /
  ``free(nbytes)``; reservations roll up the tree into the worker's
  ``MemoryPool``, which enforces ``query_max_memory_per_node``.
- ``MemoryPool`` — one per worker process (owned by the executor).
  Tracks live reservations and the lifetime high-water mark; a
  reservation that would push the pool over the per-node cap raises
  ``ExceededMemoryLimitError`` (typed, and classified non-retryable by
  FTE — an allocation that can never fit must not be hedged/retried).
- ``ClusterMemoryManager`` — coordinator-side. Aggregates per-worker
  pool snapshots shipped on task-status/heartbeat responses, enforces
  the cluster-wide ``query_max_memory``, and runs the low-memory kill
  policy: the query with the largest total reservation is killed with
  a human-readable error carrying per-worker attribution.

Accounting model: execution is batch-synchronous, so operator working
sets are reserved for the duration of one fused device computation and
freed immediately after — the governed quantity is therefore the
*peak* concurrent reservation, which is exactly the high-water mark
the spill-tier tests assert against. Revocation (MemoryRevokingScheme
analog) happens one level up, in the executor: when a hash join's
estimated resident working set exceeds the per-node cap, the operator
is switched into the ``exec/spill.py`` streamed/grace tier before any
over-cap reservation is attempted; only when even the revoked path
cannot fit does the reserve raise.
"""

from __future__ import annotations

import threading

from trino_tpu_torch import session_properties as SP

__all__ = [
    "ExceededMemoryLimitError",
    "MemoryContext",
    "MemoryPool",
    "ClusterMemoryManager",
    "validate_session_limits",
    "format_bytes",
]


class ExceededMemoryLimitError(RuntimeError):
    """A reservation (or a cluster-wide aggregate) breached a memory
    cap. Classified non-retryable by the fleet's FTE tier: retrying or
    speculating an allocation that can never fit only burns cluster
    time."""


def format_bytes(n: int) -> str:
    """Human-readable data size matching the session-property literals
    ('2GB', '512.0MB') — binary multipliers, like io.airlift DataSize."""
    n = int(n)
    for unit, mult in (("GB", 1 << 30), ("MB", 1 << 20), ("kB", 1 << 10)):
        if n >= mult:
            v = n / mult
            s = f"{v:.2f}".rstrip("0").rstrip(".")
            return f"{s}{unit}"
    return f"{n}B"


class MemoryContext:
    """One node of the query → task → operator accounting tree.

    ``reserve``/``free`` propagate up to the root and into the owning
    pool, where the per-node cap is checked; peaks are maintained at
    every level so attribution survives the frees."""

    __slots__ = ("name", "parent", "pool", "reserved_bytes",
                 "peak_bytes", "_children")

    def __init__(self, name: str, pool: "MemoryPool",
                 parent: "MemoryContext | None" = None):
        self.name = name
        self.pool = pool
        self.parent = parent
        self.reserved_bytes = 0
        self.peak_bytes = 0
        self._children: dict[str, MemoryContext] = {}

    def child(self, name: str) -> "MemoryContext":
        """Get-or-create a named child (task or operator context).
        Reuse by name keeps the tree bounded across repeated operator
        invocations."""
        with self.pool._lock:
            ctx = self._children.get(name)
            if ctx is None:
                ctx = MemoryContext(name, self.pool, parent=self)
                self._children[name] = ctx
            return ctx

    def reserve(self, nbytes: int) -> None:
        """Claim ``nbytes`` against the pool; raises
        ``ExceededMemoryLimitError`` when the pool's per-node cap would
        be breached (nothing is recorded in that case)."""
        if nbytes <= 0:
            return
        self.pool._reserve(self, int(nbytes))

    def try_reserve(self, nbytes: int) -> bool:
        """Best-effort claim: False (nothing recorded) instead of
        raising when the per-node cap would be breached. Used by the
        direct-exchange buffer pool, where a failed reservation means
        "serve this partition from the spool", not a query error —
        deliberately NOT a device-oom chaos seam, so arming that site
        keeps its existing seeded schedules."""
        if nbytes <= 0:
            return True
        try:
            self.pool._reserve(self, int(nbytes))
        except ExceededMemoryLimitError:
            return False
        return True

    def free(self, nbytes: int) -> None:
        if nbytes <= 0:
            return
        self.pool._free(self, int(nbytes))

    def reserving(self, nbytes: int):
        """Context manager: reserve for the duration of a block and
        free on exit — the streamed-batch working-set idiom (reserve a
        batch, run the compiled chain, release)."""
        import contextlib

        @contextlib.contextmanager
        def _scope():
            self.reserve(nbytes)
            try:
                yield self
            finally:
                self.free(nbytes)

        return _scope()

    def snapshot(self) -> dict:
        with self.pool._lock:
            return {
                "name": self.name,
                "reserved_bytes": self.reserved_bytes,
                "peak_bytes": self.peak_bytes,
            }


class MemoryPool:
    """Worker-local pool enforcing ``query_max_memory_per_node``.

    ``limit_provider`` is read at reservation time (session overrides
    arrive per-task on workers); 0 means unlimited. Thread-safe: the
    spill tier's double-buffered producer reserves from a prefetch
    thread while the consumer runs the chain."""

    #: per-query contexts kept after their query finishes (peaks feed
    #: system.runtime.memory and late coordinator polls); oldest idle
    #: entries beyond this are evicted so long-lived workers stay flat
    MAX_RETAINED_QUERIES = 64

    def __init__(self, limit_provider=None, node_id: str = "local-0"):
        self._lock = threading.Lock()
        self._limit_provider = limit_provider
        self.node_id = node_id
        self.reserved_bytes = 0
        #: lifetime high-water mark across all queries — the quantity
        #: the pre-governance ``tracked_bytes_hwm`` recorded
        self.peak_bytes = 0
        self._queries: dict[str, MemoryContext] = {}
        #: revocable consumers (cache tiers): ``fn(nbytes) -> freed``
        #: called OUTSIDE the pool lock when a reservation would breach
        #: the limit, before the reservation is failed
        self._revokers: list = []

    def reset_peak(self) -> None:
        """Start the high-water mark again from what is reserved now (a
        measurement of one phase on a long-lived executor)."""
        with self._lock:
            self.peak_bytes = self.reserved_bytes

    def limit_bytes(self) -> int:
        if self._limit_provider is None:
            return 0
        return int(self._limit_provider() or 0)

    def query_context(self, query_id: str) -> MemoryContext:
        """Root context for one query (get-or-create)."""
        with self._lock:
            ctx = self._queries.get(query_id)
            if ctx is None:
                self._gc_locked()
                ctx = MemoryContext(query_id, self)
                self._queries[query_id] = ctx
            return ctx

    def _gc_locked(self) -> None:
        while len(self._queries) >= self.MAX_RETAINED_QUERIES:
            victim = next(
                (q for q, c in self._queries.items()
                 if c.reserved_bytes == 0),
                None,
            )
            if victim is None:
                return
            del self._queries[victim]

    def _root(self, ctx: MemoryContext) -> MemoryContext:
        while ctx.parent is not None:
            ctx = ctx.parent
        return ctx

    def add_revoker(self, fn) -> None:
        """Register a revocable consumer. Revokers shed lowest-priority
        bytes (cache residency) when a reservation would otherwise fail,
        so cached data can never turn into a query's memory error."""
        with self._lock:
            if fn not in self._revokers:
                self._revokers.append(fn)

    def _try_commit(self, ctx: MemoryContext, nbytes: int) -> bool:
        limit = self.limit_bytes()
        with self._lock:
            if limit and self.reserved_bytes + nbytes > limit:
                return False
            cur = ctx
            while cur is not None:
                cur.reserved_bytes += nbytes
                if cur.reserved_bytes > cur.peak_bytes:
                    cur.peak_bytes = cur.reserved_bytes
                cur = cur.parent
            self.reserved_bytes += nbytes
            if self.reserved_bytes > self.peak_bytes:
                self.peak_bytes = self.reserved_bytes
            return True

    def _reserve(self, ctx: MemoryContext, nbytes: int) -> None:
        if self._try_commit(ctx, nbytes):
            return
        # would breach: ask revokers (cache tiers) to shed bytes, then
        # retry — outside the lock, since revokers free via _free
        with self._lock:
            revokers = list(self._revokers)
        for fn in revokers:
            try:
                fn(nbytes)
            except Exception:
                continue
            if self._try_commit(ctx, nbytes):
                return
        if revokers and self._try_commit(ctx, nbytes):
            return
        limit = self.limit_bytes()
        with self._lock:
            root = self._root(ctx)
            raise ExceededMemoryLimitError(
                f"Query exceeded per-node memory limit of "
                f"{format_bytes(limit)} "
                f"[query_max_memory_per_node]: requested "
                f"{format_bytes(nbytes)} in {ctx.name!r}, "
                f"{format_bytes(self.reserved_bytes)} already "
                f"reserved on {self.node_id} "
                f"(query {root.name} peak "
                f"{format_bytes(root.peak_bytes)})"
            )

    def _free(self, ctx: MemoryContext, nbytes: int) -> None:
        with self._lock:
            cur = ctx
            while cur is not None:
                cur.reserved_bytes = max(0, cur.reserved_bytes - nbytes)
                cur = cur.parent
            self.reserved_bytes = max(0, self.reserved_bytes - nbytes)

    def snapshot(self) -> dict:
        """JSON-safe pool state shipped on task-status/heartbeat
        responses and read by system.runtime.memory."""
        with self._lock:
            return {
                "node_id": self.node_id,
                "reserved_bytes": self.reserved_bytes,
                "peak_bytes": self.peak_bytes,
                "limit_bytes": self.limit_bytes(),
                "queries": {
                    qid: {
                        "reserved_bytes": c.reserved_bytes,
                        "peak_bytes": c.peak_bytes,
                    }
                    for qid, c in self._queries.items()
                },
            }


class ClusterMemoryManager:
    """Coordinator-side aggregate over per-worker pool snapshots.

    ``observe`` ingests a pool snapshot from a task-status poll or
    heartbeat; ``enforce`` applies the cluster-wide cap and the kill
    policy. Batch-synchronous reservations are transient, so the
    governed per-query quantity is the peak reservation on each
    worker, summed across workers."""

    def __init__(self):
        self._lock = threading.Lock()
        #: node -> most recent pool snapshot
        self._nodes: dict[str, dict] = {}

    def observe(self, node: str, snapshot: dict | None) -> None:
        if not snapshot:
            return
        with self._lock:
            self._nodes[str(node)] = snapshot

    def nodes(self) -> dict[str, dict]:
        with self._lock:
            return dict(self._nodes)

    def per_worker(self, query_id: str) -> dict[str, int]:
        """node -> peak bytes this query reserved there."""
        out = {}
        with self._lock:
            for node, snap in self._nodes.items():
                q = (snap.get("queries") or {}).get(query_id)
                if q:
                    out[node] = int(q.get("peak_bytes", 0))
        return out

    def query_total(self, query_id: str) -> int:
        return sum(self.per_worker(query_id).values())

    def query_totals(self) -> dict[str, int]:
        totals: dict[str, int] = {}
        with self._lock:
            for snap in self._nodes.values():
                for qid, q in (snap.get("queries") or {}).items():
                    totals[qid] = totals.get(qid, 0) + int(
                        q.get("peak_bytes", 0)
                    )
        return totals

    def pick_victim(
        self, cap_bytes: int, running=None
    ) -> tuple[str, str] | None:
        """Low-memory kill policy, selection only: among ``running``
        queries (all observed ones when None), find the query with the
        LARGEST cluster-total reservation; return ``(query_id, error
        message with per-worker attribution)`` when it exceeds the
        cap, else None. Selection is separated from the raise so a
        multi-query serving layer can kill a victim OTHER than the
        query whose dispatch loop noticed the breach — the reference's
        ClusterMemoryManager kills the biggest query on the cluster,
        not necessarily the one that tripped the check."""
        if not cap_bytes:
            return None
        totals = self.query_totals()
        # the device-cache tier reserves under a pseudo-query context
        # named "cache" on every worker pool; it is revocable storage,
        # never a killable query (pressure evicts it via pool revokers)
        totals.pop("cache", None)
        if running is not None:
            totals = {q: t for q, t in totals.items() if q in running}
        if not totals:
            return None
        victim = max(totals, key=lambda q: totals[q])
        if totals[victim] <= cap_bytes:
            return None
        per = self.per_worker(victim)
        attribution = ", ".join(
            f"{node}={format_bytes(b)}" for node, b in sorted(per.items())
        )
        return victim, (
            f"Query {victim} killed by the cluster memory manager: "
            f"total reservation {format_bytes(totals[victim])} across "
            f"{len(per)} worker(s) exceeds query_max_memory "
            f"{format_bytes(cap_bytes)} ({attribution})"
        )

    def enforce(self, cap_bytes: int, running=None) -> None:
        """Cluster-wide ``query_max_memory`` + low-memory kill policy:
        when any query's cluster-total reservation exceeds the cap,
        the query with the LARGEST total is killed, with per-worker
        attribution in the error text. ``running`` (optional set of
        query ids) restricts the kill candidates: worker pools retain
        finished queries' peaks for observability, and a finished
        query cannot be killed."""
        picked = self.pick_victim(cap_bytes, running)
        if picked is None:
            return
        raise ExceededMemoryLimitError(picked[1])


def validate_session_limits(session) -> None:
    """Statement-time consistency check over the memory caps: an
    inconsistent combination fails fast with a ValueError (already a
    non-retryable class for FTE) instead of being silently accepted."""
    qmax = SP.parse_data_size(SP.get(session, "query_max_memory"))
    per_node = SP.parse_data_size(
        SP.get(session, "query_max_memory_per_node")
    )
    if qmax and per_node > qmax:
        raise ValueError(
            f"query_max_memory_per_node ({format_bytes(per_node)}) "
            f"must not exceed query_max_memory ({format_bytes(qmax)})"
        )
    hbm = int(SP.get(session, "hbm_budget_bytes"))
    if per_node and hbm > per_node:
        raise ValueError(
            f"hbm_budget_bytes ({format_bytes(hbm)}) must not exceed "
            f"query_max_memory_per_node ({format_bytes(per_node)})"
        )
