"""Distributed plan execution over a device mesh — the port of
``trino_tpu/exec/mesh.py``.

The analog of the reference's worker tier (fragment pipelines plus the
shuffle subsystem) over the port's device-list mesh (``parallel/core``):

- a ``ShardedPage`` is the distributed Page: one ``Page`` per shard, all
  of one ``shard_capacity``, each on its shard's device; names, types,
  dictionaries and hash pools are shared. Row order carries no meaning
  across shards (a bag of rows).
- fusable operator chains are built once (``stage.build_chain``, as the
  local executor builds them) and applied to every shard; the overflow
  flags of all shards meet in one host OR and the retry-larger loop
  grows every shard's tables together;
- the hash and range ``Exchange`` pack each shard's rows into fixed-size
  per-destination buckets with M1 (``kernels.partition_pack``) and swap
  them with ``parallel.exchange.all_to_all``; a bucket overflow
  escalates the bucket capacity (x4, up to the shard capacity), then
  raises ``SkewOverflow``;
- joins co-partition or broadcast their build side and run shard-local
  sort-probe joins (K3/K4); data-dependent output capacities come from
  one host sync over every shard's match count (the build-side
  barrier); a probe whose exchange destinations are skewed takes the
  skew split;
- ``Exchange(single)`` gathers a ShardedPage into an ordinary Page;
  everything above it runs on the inherited local executor.

The JAX package compiles each of these steps as one ``shard_map``-ped
program and caches it; PyTorch runs eagerly, so there is no program
cache here.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from trino_tpu_torch import types as T
from trino_tpu_torch.exec import kernels as K
from trino_tpu_torch.exec import shapes, stage
from trino_tpu_torch.exec.failure import FailureInjector
from trino_tpu_torch.exec.local import (
    LocalExecutor, _concat_sections, _expr_symbols, _gather_pair_env,
    _null_section, _pair_layout, _scan_column,
)
from trino_tpu_torch.expr.compiler import compile_expr
from trino_tpu_torch.metadata import Metadata, Session
from trino_tpu_torch.page import Column, Page, _remap, pad_capacity
from trino_tpu_torch.parallel.core import Mesh
from trino_tpu_torch.parallel.exchange import all_gather, all_to_all, pack_shards
from trino_tpu_torch.plan import nodes as P

__all__ = ["MeshExecutor", "ShardedPage", "SkewOverflow"]

I64 = torch.int64


class SkewOverflow(RuntimeError):
    """An exchange destination overflowed the per-shard capacity even
    at the maximum bucket size — hash partitioning alone cannot place
    this data (a hot key owns more rows than one shard holds). Join
    callers recover via the skew-split path; other callers surface it."""


@dataclass
class ShardedPage:
    """A columnar batch split over the mesh: ``shards[s]`` is shard s's
    Page on its device; every shard has the same names, column types,
    dictionaries, hash pools, validity layout and capacity."""

    names: list[str]
    shards: list[Page]

    @property
    def n_shards(self) -> int:
        return len(self.shards)

    @property
    def shard_capacity(self) -> int:
        return self.shards[0].capacity

    @property
    def masks(self) -> list[torch.Tensor]:
        return [p.mask for p in self.shards]

    def column(self, name: str) -> Column:
        """Shard 0's column: the metadata every shard shares."""
        return self.shards[0].column(name)

    def with_masks(self, masks) -> "ShardedPage":
        return ShardedPage(list(self.names), [
            Page(list(self.names), list(p.columns), m)
            for p, m in zip(self.shards, masks)
        ])


def _page_leaves(page: Page) -> tuple[list, list[tuple[str, bool]]]:
    """Flatten a Page into [data, valid?...] leaves (mask not included)."""
    leaves, meta = [], []
    for n, c in zip(page.names, page.columns):
        leaves.append(c.data)
        if c.valid is not None:
            leaves.append(c.valid)
        meta.append((n, c.valid is not None))
    return leaves, meta


def _page_from_leaves(template: Page, leaves, mask) -> Page:
    """A Page with ``template``'s names and column metadata over new
    leaves (as ``_page_leaves`` lays them out) and mask."""
    cols, i = [], 0
    for c in template.columns:
        data = leaves[i]
        i += 1
        valid = None
        if c.valid is not None:
            valid = leaves[i]
            i += 1
        cols.append(Column(c.type, data, valid, c.dictionary, c.hash_pool))
    return Page(list(template.names), cols, mask)


def _exchange_key_pairs(cols):
    """(data, valid) pairs for exchange-key hashing: hash-coded varchar
    contributes its hash lane only (the id lane is row identity and
    would split equal strings across destinations); two-limb decimals
    contribute both limbs."""
    pairs = []
    for c in cols:
        if c.hash_pool is not None:
            pairs.append((c.data[:, 0], c.valid))
            continue
        pairs.extend(
            (p, c.valid if i == 0 else None)
            for i, p in enumerate(K.limb_parts(c.data))
        )
    return pairs


def _to_device(page: Page, device) -> Page:
    """``page`` with its tensors on ``device`` (itself when already)."""
    if page.mask.device == torch.device(device):
        return page
    cols = [
        Column(c.type, c.data.to(device),
               None if c.valid is None else c.valid.to(device),
               c.dictionary, c.hash_pool)
        for c in page.columns
    ]
    return Page(list(page.names), cols, page.mask.to(device),
                known_rows=page.known_rows, packed=page.packed)


def _compact_to(page: Page, n_live: int, cap: int) -> Page:
    """Live rows first (stable), cut to ``cap`` rows; ``n_live`` known."""
    perm = torch.sort((~page.mask).to(torch.int8), stable=True).indices[:cap]
    cols = [
        Column(c.type, c.data[perm], None if c.valid is None else c.valid[perm],
               c.dictionary, c.hash_pool)
        for c in page.columns
    ]
    return Page(list(page.names), cols, page.mask[perm], known_rows=n_live,
                packed=True)


class MeshExecutor(LocalExecutor):
    """Executes distribution-planned trees (``plan.distribute``) over a
    device-list mesh; single-prop regions fall through to the inherited
    local executor, on the mesh's first device."""

    #: probes below this skip the skew histogram
    SKEW_MIN_PROBE = 1 << 16
    #: a destination this many times above the mean marks skew
    SKEW_FACTOR = 4.0

    def __init__(self, metadata: Metadata, session: Session, mesh: Mesh):
        super().__init__(metadata, session, mesh.devices[0])
        self.mesh = mesh
        self.devices = list(mesh.devices)
        self.n_shards = mesh.n_shards
        self._dist_scan_cache: dict = {}
        #: test hook: arm per-stage failures; stage steps retry
        self.failure_injector = FailureInjector()
        #: joins that took the skew-split path
        self.skew_joins = 0
        #: exchange bucket-capacity escalations
        self.exchange_escalations = 0
        #: range exchanges (distributed ORDER BY) run
        self.range_exchanges = 0
        #: exchange count and bytes moved through them (global, all
        #: shards' leaves and masks), per-edge partition histograms
        self.exchange_stats = {"exchanges": 0, "bytes": 0}
        #: host syncs the mesh steps made (capacity decisions, overflow
        #: flags, gathers); the JAX package makes one per such step
        self.host_syncs = 0
        #: dynamic-filter outcomes (bounded)
        self.df_log: list[dict] = []
        self._exchange_count_seq = 0
        self._dest_memo = None

    def _sync(self, tensors) -> np.ndarray:
        """One host sync: the stacked scalars (or equal-shape tensors) of
        every shard, as a host array."""
        self.host_syncs += 1
        dev = tensors[0].device
        return torch.stack([t.to(dev) for t in tensors]).cpu().numpy()

    def _attempt(self, tag: str, call):
        """Run one stage step with injected-failure retry: stage inputs
        are retained tensors, so a failed invocation re-runs against
        them (the fault-tolerant scheduler's retry unit)."""
        from trino_tpu_torch import fault

        attempt = 0
        while True:
            try:
                self.failure_injector.check(tag, attempt)
                fault.check("task-exec", tag, attempt)
                return call()
            except fault.InjectedFault:
                attempt += 1
                if attempt >= self.failure_injector.max_attempts:
                    raise

    # ---- boundaries ------------------------------------------------------

    def _Exchange(self, node: P.Exchange) -> Page:
        if node.partitioning != "single":
            raise AssertionError("non-single exchange reached the local executor")
        return self.gather(self.execute_dist(node.source))

    def execute_dist(self, node: P.PlanNode) -> ShardedPage:
        if isinstance(node, stage.FUSABLE):
            chain: list[P.PlanNode] = []
            cur = node
            while isinstance(cur, stage.FUSABLE):
                chain.append(cur)
                cur = cur.sources[0]
            base = self.execute_dist(cur)
            return self._run_chain_sharded(list(reversed(chain)), base)
        if isinstance(node, P.TableScan):
            if node.split is not None:
                raise NotImplementedError("split scans on the mesh")
            return self._scan_dist(node)
        if isinstance(node, P.Exchange):
            if node.partitioning == "hash":
                return self.hash_exchange(
                    self.execute_dist(node.source), node.hash_symbols)
            if node.partitioning == "range":
                return self.range_exchange(
                    self.execute_dist(node.source), node.sort_keys)
            raise AssertionError(
                f"exchange {node.partitioning} cannot produce a sharded page")
        if isinstance(node, P.Join):
            return self._dist_join(node)
        if isinstance(node, P.SemiJoin):
            return self._dist_semi(node)
        if isinstance(node, P.GroupId):
            return self._dist_groupid(node)
        raise NotImplementedError(
            f"no distributed executor for {type(node).__name__}")

    # ---- scan / gather / scatter ----------------------------------------

    def _shard_layout(self, n: int) -> tuple[int, int]:
        """(rows per shard, padded per-shard capacity) for n rows."""
        per = -(-max(n, 1) // self.n_shards)  # ceil
        return per, pad_capacity(per)

    def _shard_split(self, t: torch.Tensor, n: int, per: int, cap: int):
        """Lay the first n rows of ``t`` contiguously over the shards,
        each padded to ``cap`` rows on its device."""
        out = []
        for s, dev in enumerate(self.devices):
            lo = min(s * per, n)
            hi = min(lo + per, n)
            part = torch.zeros((cap,) + tuple(t.shape[1:]), dtype=t.dtype,
                               device=dev)
            part[: hi - lo] = t[lo:hi].to(dev)
            out.append(part)
        return out

    def _scan_dist(self, node: P.TableScan) -> ShardedPage:
        key = (node.catalog, node.schema, node.table)
        connector = self.metadata.connector(node.catalog)
        if not connector.cacheable:
            cache = {}  # live views re-scan per query
        else:
            cache = self._dist_scan_cache.setdefault(key, {})
        hashed_syms = set(node.hash_varchar or [])

        def ckey(sym, cname):
            return f"#hash:{cname}" if sym in hashed_syms else cname

        missing = [
            (sym, c) for sym, c in node.assignments.items()
            if ckey(sym, c) not in cache
        ]
        if missing or "" not in cache:
            cols = connector.scan(node.schema, node.table, [c for _, c in missing])
            if missing:
                first = cols[missing[0][1]]
                n = len(first[0] if isinstance(first, tuple) else first)
            else:
                n = connector.row_count(node.schema, node.table)
            per, cap = self._shard_layout(n)
            if "" not in cache:
                cache[""] = self._shard_split(
                    torch.ones(n, dtype=torch.bool), n, per, cap)
            for sym, cname in missing:
                # global dictionaries, pools and row ids: the id lane of
                # a hash-coded column stays meaningful on every shard
                col = _scan_column(node.outputs[sym], cols[cname], max(n, 1),
                                   "cpu", hashed=sym in hashed_syms)
                data = self._shard_split(col.data, n, per, cap)
                valid = (
                    [None] * self.n_shards if col.valid is None
                    else self._shard_split(col.valid, n, per, cap)
                )
                cache[ckey(sym, cname)] = [
                    Column(col.type, d, v, col.dictionary, col.hash_pool)
                    for d, v in zip(data, valid)
                ]
        names = list(node.assignments)
        shards = [
            Page(names, [cache[ckey(sym, c)][s]
                         for sym, c in node.assignments.items()], cache[""][s])
            for s in range(self.n_shards)
        ]
        return ShardedPage(names, shards)

    def gather(self, sp: ShardedPage) -> Page:
        """ShardedPage -> compacted Page on the executor's device, shard by
        shard in row order (one host sync for the live counts)."""
        counts = self._sync([K.count_true(m) for m in sp.masks])
        total = int(counts.sum())
        cap = pad_capacity(total)
        parts = [
            _to_device(_compact_to(p, int(k), int(k)), self.device)
            for p, k in zip(sp.shards, counts)
        ]
        cols = []
        for i, c in enumerate(sp.shards[0].columns):
            data = torch.cat([p.columns[i].data for p in parts])
            data = torch.cat([data, torch.zeros(
                (cap - total,) + tuple(data.shape[1:]), dtype=data.dtype,
                device=self.device)])
            valid = None
            if c.valid is not None:
                valid = torch.zeros(cap, dtype=torch.bool, device=self.device)
                valid[:total] = torch.cat([p.columns[i].valid for p in parts])
            cols.append(Column(c.type, data, valid, c.dictionary, c.hash_pool))
        mask = torch.zeros(cap, dtype=torch.bool, device=self.device)
        mask[:total] = True
        return Page(list(sp.names), cols, mask, known_rows=total, packed=True)

    def scatter(self, page: Page) -> ShardedPage:
        """Split a local Page's live rows contiguously over the mesh."""
        n = page.num_rows()
        page = _compact_to(page, n, max(n, 1))
        per, cap = self._shard_layout(n)
        cols = []
        for c in page.columns:
            data = self._shard_split(c.data, n, per, cap)
            valid = (
                [None] * self.n_shards if c.valid is None
                else self._shard_split(c.valid, n, per, cap)
            )
            cols.append([
                Column(c.type, d, v, c.dictionary, c.hash_pool)
                for d, v in zip(data, valid)
            ])
        masks = self._shard_split(torch.ones(n, dtype=torch.bool), n, per, cap)
        names = list(page.names)
        return ShardedPage(names, [
            Page(names, [col[s] for col in cols], masks[s])
            for s in range(self.n_shards)
        ])

    def _broadcast_page(self, node) -> Page:
        """Resolve an Exchange(broadcast) into one compacted local Page
        (copied to each shard's device where it is used)."""
        if node.input_dist == "single":
            return self._compact(self.execute(node.source))
        return self.gather(self.execute_dist(node.source))

    def _build_for(self, build, s: int):
        """Shard s's build side: its own shard, or the replicated page on
        its device."""
        if isinstance(build, ShardedPage):
            return build.shards[s]
        return _to_device(build, self.devices[s])

    # ---- sharded fused chains -------------------------------------------

    def _run_chain_sharded(self, chain: list[P.PlanNode], sp: ShardedPage) -> ShardedPage:
        """The chain built once per device and run on every shard; the
        overflow flags of all shards meet in one host sync, and every
        shard's tables grow together on a retry."""
        shard_cap = sp.shard_capacity
        caps = stage.plan_capacities(chain, shard_cap, n_shards=self.n_shards)
        first = sp.shards[0]
        while True:
            built: dict = {}

            def run():
                outs = []
                for page in sp.shards:
                    dev = page.mask.device
                    if dev not in built:
                        layout = stage.ChainLayout(
                            names=list(first.names),
                            types={n: c.type for n, c in zip(first.names, first.columns)},
                            dicts={n: c.dictionary for n, c in zip(first.names, first.columns)},
                            capacity=shard_cap,
                            device=dev,
                            pools={
                                n: c.hash_pool
                                for n, c in zip(first.names, first.columns)
                                if c.hash_pool is not None
                            },
                        )
                        built[dev] = stage.build_chain(chain, layout, caps)
                    fn, _ = built[dev]
                    outs.append(fn(self._env(page), page.mask))
                return outs

            outs = self._attempt("chain", run)
            out_layout = next(iter(built.values()))[1]
            flag_ids = sorted(outs[0][2])
            if flag_ids:
                vals = self._sync([
                    torch.stack([o[2][i].to(torch.bool) for i in flag_ids])
                    for o in outs
                ]).any(axis=0)
                overflowed = [i for i, v in zip(flag_ids, vals) if v]
                if overflowed:
                    for i in overflowed:
                        cap, mx = caps[i]
                        if cap >= mx:
                            raise RuntimeError(
                                "aggregation table overflow at max capacity")
                        caps[i][0] = min(cap * 8, mx)
                    continue
            names = list(out_layout.names)
            return ShardedPage(names, [
                Page(names, [
                    Column(out_layout.types[s], env[s][0], env[s][1],
                           out_layout.dicts.get(s), out_layout.pools.get(s))
                    for s in names
                ], mask)
                for env, mask, _ in outs
            ])

    # ---- exchanges -------------------------------------------------------

    def _hash_dests(self, sp: ShardedPage, key_symbols) -> list[torch.Tensor]:
        """Each shard's destination per row: the key hash (K7) modulo the
        shard count, unsigned as in the JAX package."""
        return [
            K.umod(K.hash_keys(_exchange_key_pairs(
                [p.column(k) for k in key_symbols])), self.n_shards)
            for p in sp.shards
        ]

    def hash_exchange(self, sp: ShardedPage, key_symbols: list[str]) -> ShardedPage:
        return self.exchange_by_dest(
            sp, self._hash_dests(sp, key_symbols),
            edge=f"mesh-hash({', '.join(key_symbols)})",
        )

    def range_exchange(self, sp: ShardedPage, sort_keys) -> ShardedPage:
        """Distributed-sort shuffle: rows route to shards by sampled
        splitters of the first sort key, so shard-local sorts
        concatenate into global order; equal keys colocate, so ties
        never straddle a shard boundary. The sample takes the JAX
        package's positions of the padded global layout (every
        ``max(len // 4096, 1)``-th row of the shards concatenated), so
        the splitters equal its."""
        k = sort_keys[0]
        col = sp.column(k.symbol)
        if col.hash_pool is not None:
            raise AssertionError(
                "range exchange over a hash-coded varchar key (the stats "
                "gate must keep ORDER BY columns dictionary-coded)")
        nulls_first = k.nulls_first if k.nulls_first is not None else not k.ascending
        cap = sp.shard_capacity
        stride = max(self.n_shards * cap // 4096, 1)
        bits, samples, sample_live = [], [], []
        for s, p in enumerate(sp.shards):
            c = p.column(k.symbol)
            d = c.data[:, 0] if c.data.dim() == 2 else c.data
            # the port's signed order bits: u64 order bits ^ bit 63
            b = K.order_bits(d)
            if not k.ascending:
                b = ~b
            if c.valid is not None:
                sentinel = -(1 << 63) if nulls_first else (1 << 63) - 1
                b = torch.where(c.valid, b, torch.full_like(b, sentinel))
            bits.append(b)
            first = (-s * cap) % stride
            samples.append(b[first::stride])
            sample_live.append(p.mask[first::stride])
        sample, live = self._sync([
            torch.cat(samples), torch.cat(sample_live).to(I64)])
        # back to the JAX package's u64 bits for the same numpy quantile
        sample = (sample[live != 0] ^ np.int64(-(1 << 63))).view(np.uint64)
        if len(sample) == 0:
            dests = [torch.zeros_like(b) for b in bits]
        else:
            qs = np.quantile(
                np.sort(sample),
                [i / self.n_shards for i in range(1, self.n_shards)],
                method="nearest",
            ).astype(np.uint64)
            signed = torch.from_numpy(
                (qs.view(np.int64) ^ np.int64(-(1 << 63))).copy())
            dests = [
                torch.searchsorted(signed.to(b.device), b, right=True)
                for b in bits
            ]
        self.range_exchanges += 1
        return self.exchange_by_dest(sp, dests, edge=f"mesh-range({k.symbol})")

    def exchange_by_dest(self, sp: ShardedPage, dests, edge: str = "mesh-exchange") -> ShardedPage:
        """Route every live row to the shard named by ``dests`` — the
        engine's shuffle: M1 on every shard, one host sync for the
        per-destination counts, then ``all_to_all``; a bucket overflow
        escalates the bucket capacity (the OutputBuffer backpressure
        analog)."""
        from trino_tpu_torch import session_properties as SP

        shard_cap = sp.shard_capacity
        n = self.n_shards
        bucket_cap = shapes.exchange_bucket(shard_cap, n)
        payloads = [_page_leaves(p)[0] for p in sp.shards]
        masks = sp.masks
        self.exchange_stats["exchanges"] += 1
        self.exchange_stats["bytes"] += sum(
            t.numel() * t.element_size() for leaves in payloads for t in leaves
        ) + sum(m.numel() for m in masks)
        while True:
            packed, counts = self._attempt(
                "exchange",
                lambda: pack_shards(dests, masks, payloads, n, bucket_cap),
            )
            self.host_syncs += 1
            overflowed = bool((counts > bucket_cap).any())
            if overflowed and bucket_cap < shard_cap:
                self.exchange_escalations += 1
                bucket_cap = min(bucket_cap * 4, shard_cap)
                continue
            if overflowed:
                raise SkewOverflow("exchange bucket overflow at max capacity")
            break
        recv = all_to_all(packed, self.devices, bucket_cap)
        del packed
        out = ShardedPage(list(sp.names), [
            _page_from_leaves(sp.shards[0], r[:-1], r[-1]) for r in recv
        ])
        count_now = bool(SP.get(self.session, "exchange_partition_counters"))
        if not count_now:
            n_sample = int(SP.get(self.session, "exchange_partition_counter_sample"))
            if n_sample > 0:
                seq = self._exchange_count_seq
                self._exchange_count_seq = seq + 1
                count_now = (seq % n_sample) == 0
        if count_now:
            # the per-destination live rows came with the overflow check
            hist = self.exchange_stats.setdefault(
                "partition_rows", {}).setdefault(edge, {})
            for p, c in enumerate(counts.sum(axis=0)):
                if c:
                    hist[p] = hist.get(p, 0) + int(c)
        if SP.get(self.session, "check_exchange_coverage"):
            from trino_tpu_torch.plan.validate import ExchangeCoverageError

            n_in = int(counts.sum())
            n_out = int(self._sync([K.count_true(m) for m in out.masks]).sum())
            if n_in != n_out:
                raise ExchangeCoverageError(
                    edge, n_in, n_out,
                    detail=f"{n}-shard all_to_all, bucket_cap={bucket_cap}",
                )
        return out

    # ---- distributed joins ----------------------------------------------

    @staticmethod
    def _remap_column(side, name: str, remap, merged) -> None:
        pages = side.shards if isinstance(side, ShardedPage) else [side]
        for p in pages:
            i = p.names.index(name)
            p.columns[i] = _remap(p.columns[i], remap, merged)

    def _unify_key_dicts(self, left, right, criteria) -> None:
        """Remap varchar join keys onto shared dictionaries on every shard
        BEFORE any hashing, so co-partitioning routes equal strings to the
        same shard whichever table they came from."""
        for ls, rs in criteria:
            lc, rc = left.column(ls), right.column(rs)
            if lc.hash_pool is not None and rc.hash_pool is not None:
                # hash codes are global; only the cross-pool proof
                lc.hash_pool.verify_joinable(rc.hash_pool)
                continue
            if lc.hash_pool is not None or rc.hash_pool is not None:
                raise NotImplementedError(
                    "join between hash-coded and dictionary-coded varchar "
                    "(the planner co-encodes join pairs)")
            if lc.dictionary is None and rc.dictionary is None:
                continue
            if lc.dictionary is None or rc.dictionary is None:
                raise ValueError("both columns must be dictionary-encoded")
            if lc.dictionary is rc.dictionary:
                continue
            merged, ra, rb = lc.dictionary.union(rc.dictionary)
            self._remap_column(left, ls, ra, merged)
            self._remap_column(right, rs, rb, merged)

    def _dist_join(self, node: P.Join) -> ShardedPage:
        if node.kind == "cross":
            return self._dist_cross(node)
        if not node.criteria:
            raise NotImplementedError(
                f"_Join: {node.kind} join without equi-criteria")
        kind, criteria = node.kind, list(node.criteria)
        if node.distribution == "BROADCAST":
            probe = self.execute_dist(node.left)
            build = self._broadcast_page(node.right)
            self._unify_key_dicts(probe, build, criteria)
            if kind == "inner":
                probe = self._dynamic_filter_sharded(node, probe, build, criteria)
            replicated = True
        else:
            left = self.execute_dist(node.left)
            right = self.execute_dist(node.right)
            if kind == "right":
                left, right = right, left
                criteria = [(b, a) for a, b in criteria]
                kind = "left"
            self._unify_key_dicts(left, right, criteria)
            if kind == "inner":
                # prune BEFORE the exchange: fewer exchanged rows and
                # smaller co-partitioned shard capacities
                left = self._dynamic_filter_sharded(node, left, right, criteria)
            out = None
            if kind == "inner" and self._probe_is_skewed(left, criteria):
                out = self._skew_join(node, left, right, criteria)
            if out is not None:
                return out
            try:
                probe = self.hash_exchange(left, [a for a, _ in criteria])
                build = self.hash_exchange(right, [b for _, b in criteria])
            except SkewOverflow:
                if kind != "inner":
                    raise
                out = self._skew_join(node, left, right, criteria)
                if out is None:
                    raise
                return out
            replicated = False
        if kind == "right":
            # BROADCAST right joins never occur (distribute forces
            # PARTITIONED), so kind is inner/left/full here
            raise AssertionError("unflipped right join in mesh executor")
        return self._equi_join_sharded(
            node, probe, build, replicated, kind, criteria, list(node.outputs))

    def _dynamic_filter_sharded(self, node: P.Join, probe: ShardedPage, build,
                                criteria) -> ShardedPage:
        """Distributed dynamic filtering: prune probe rows whose join key
        matches NO build row, BEFORE the exchange. An exact membership
        probe (join phase A as a filter, K3): only the build KEYS cross
        shards (every shard's build keys gathered in shard order), and
        uniform dense keys, where min/max never prunes, still drop.
        Multi-key criteria use the hash-combined key, so false positives
        pass harmlessly to the real join. Inner joins only."""
        from trino_tpu_torch import session_properties as SP

        if not SP.get(self.session, "dynamic_filtering_enabled"):
            return probe
        if probe.shard_capacity * probe.n_shards < self.DF_MIN_PROBE:
            return probe
        # planner hint: a near-1.0 keep fraction makes the pass pure cost
        if node.df_keep_frac is None or node.df_keep_frac > 0.7:
            return probe
        keys = []
        for s, pp in enumerate(probe.shards):
            pb = self._build_for(build, s)
            pk, bk, pv, bv, _, _ = self._join_keys(pp, pb, criteria)
            keys.append((
                pk, pp.mask if pv is None else (pp.mask & pv),
                bk, pb.mask if bv is None else (pb.mask & bv),
            ))
        replicated = not isinstance(build, ShardedPage)

        def run():
            keep = []
            for s, (pk, probe_live, bk, build_live) in enumerate(keys):
                if not replicated:
                    bk = all_gather([k[2] for k in keys], pk.device)
                    build_live = all_gather([k[3] for k in keys], pk.device)
                _, _, cnt = K.join_ranges(bk, build_live, pk, probe_live)
                keep.append(probe_live & (cnt > 0))
            return keep

        keep = self._attempt("dynamic-filter", run)
        counts = self._sync([
            torch.stack([K.count_true(p.mask), K.count_true(k)])
            for p, k in zip(probe.shards, keep)
        ])
        in_rows, kept = int(counts[:, 0].sum()), int(counts[:, 1].sum())
        self.df_log.append(
            {"rows_in": in_rows, "rows_kept": kept, "pairs": list(criteria)})
        del self.df_log[:-100]  # bounded: executors outlive queries
        if kept > (1.0 - self.DF_MIN_DROP) * max(in_rows, 1):
            return probe
        new_cap = pad_capacity(int(max(counts[:, 1].max(), 1)))
        narrowed = probe.with_masks(keep)
        if new_cap >= probe.shard_capacity:
            return narrowed  # no capacity win; still use the narrowed mask
        return ShardedPage(list(probe.names), [
            _compact_to(p, int(k), new_cap)
            for p, k in zip(narrowed.shards, counts[:, 1])
        ])

    # ---- skew-split join -------------------------------------------------

    def _probe_is_skewed(self, probe: ShardedPage, criteria) -> bool:
        """One cheap histogram: is any exchange destination loaded far
        beyond the mean? The (dests, counts) pair memoizes for
        ``_skew_join``'s immediate reuse."""
        if probe.shard_capacity * probe.n_shards < self.SKEW_MIN_PROBE:
            return False
        keys = tuple(a for a, _ in criteria)
        dests, counts = self._dest_counts(probe, list(keys))
        total = counts.sum()
        if total == 0:
            return False
        skewed = bool(counts.max() > self.SKEW_FACTOR * (total / self.n_shards))
        # one-shot memo: holding the page any longer would pin memory
        self._dest_memo = (probe, keys, dests, counts) if skewed else None
        return skewed

    def _dest_counts_memo(self, sp: ShardedPage, key_syms: list[str]):
        memo, self._dest_memo = self._dest_memo, None
        if memo is not None and memo[0] is sp and memo[1] == tuple(key_syms):
            return memo[2], memo[3]
        return self._dest_counts(sp, key_syms)

    def _dest_counts(self, sp: ShardedPage, key_syms: list[str]):
        """(dest per row per shard, global per-destination live rows):
        each shard's histogram is an M2 sum of its live flags by
        destination; one host sync."""
        dests = self._hash_dests(sp, key_syms)
        hists = [
            K.segment_reduce(m.to(I64), d, self.n_shards, "sum")
            for d, m in zip(dests, sp.masks)
        ]
        return dests, self._sync(hists).sum(axis=0)

    def _skew_join(self, node: P.Join, left: ShardedPage, right: ShardedPage,
                   criteria) -> ShardedPage | None:
        """Inner join under destination skew: split the BUILD side into
        hot destinations (gathered and broadcast to every shard) and cold
        ones (hash-partitioned as usual); hot PROBE rows salt round-robin
        by global position across the mesh. The two joins partition the
        key space disjointly, so their union is the exact join."""
        lkeys = [a for a, _ in criteria]
        rkeys = [b for _, b in criteria]
        p_dest, p_counts = self._dest_counts_memo(left, lkeys)
        b_dest, b_counts = self._dest_counts(right, rkeys)
        shard_cap = left.shard_capacity
        mean = max(p_counts.sum() / self.n_shards, 1.0)
        hot = (p_counts > shard_cap // 2) | (p_counts > self.SKEW_FACTOR * mean)
        # the hot builds replicate to every shard: bail out to the plain
        # exchange when that replica would itself be oversized
        if not hot.any() or b_counts[hot].sum() > 4 * right.shard_capacity:
            return None
        self.skew_joins += 1
        hot_t = torch.from_numpy(hot)
        n = self.n_shards
        salted = []
        for s, d in enumerate(p_dest):
            hot_d = hot_t.to(d.device)
            rr = (torch.arange(d.shape[0], dtype=I64, device=d.device)
                  + s * shard_cap) % n
            salted.append(torch.where(hot_d[d], rr, d))
        probe = self.exchange_by_dest(left, salted)
        hot_rows = [hot_t.to(d.device)[d] for d in b_dest]
        cold = right.with_masks([m & ~h for m, h in zip(right.masks, hot_rows)])
        build_cold = self.hash_exchange(cold, rkeys)
        build_hot = self.gather(
            right.with_masks([m & h for m, h in zip(right.masks, hot_rows)]))
        out_syms = list(node.outputs)
        part1 = self._equi_join_sharded(
            node, probe, build_cold, False, "inner", criteria, out_syms)
        part2 = self._equi_join_sharded(
            node, probe, build_hot, True, "inner", criteria, out_syms)
        return self._concat_sharded(part1, part2)

    def _dist_groupid(self, node: P.GroupId) -> ShardedPage:
        """Shard-local GroupId: each shard concatenates k masked copies of
        its rows (no exchange; the aggregation above hash-exchanges on
        (id, keys))."""
        src = self.execute_dist(node.source)
        k = len(node.grouping_sets)
        sets = [tuple(st) for st in node.grouping_sets]
        keyed = set(s for st in sets for s in st)
        names = list(src.names) + [node.id_symbol]
        shards = []
        for page in src.shards:
            dev = page.mask.device
            n = page.capacity
            cols = []
            for name, c in zip(page.names, page.columns):
                valid = None
                if name in keyed:
                    vf = c.valid if c.valid is not None else torch.ones(
                        n, dtype=torch.bool, device=dev)
                    none = torch.zeros(n, dtype=torch.bool, device=dev)
                    valid = torch.cat([vf if name in st else none for st in sets])
                elif c.valid is not None:
                    valid = torch.cat([c.valid] * k)
                cols.append(Column(c.type, torch.cat([c.data] * k), valid,
                                   c.dictionary, c.hash_pool))
            cols.append(Column(T.BIGINT, torch.cat([
                torch.full((n,), i, dtype=I64, device=dev) for i in range(k)
            ])))
            shards.append(Page(names, cols, torch.cat([page.mask] * k)))
        return ShardedPage(names, shards)

    def _concat_sharded(self, a: ShardedPage, b: ShardedPage) -> ShardedPage:
        """Per-shard concatenation of two same-layout sharded pages."""
        shards = []
        for pa, pb in zip(a.shards, b.shards):
            cols = [
                Column(ca.type, *_concat_sections([(ca.data, ca.valid),
                                                   (cb.data, cb.valid)]),
                       ca.dictionary, ca.hash_pool)
                for ca, cb in zip(pa.columns, pb.columns)
            ]
            shards.append(Page(list(a.names), cols, torch.cat([pa.mask, pb.mask])))
        return ShardedPage(list(a.names), shards)

    def _join_count_sharded(self, probe: ShardedPage, build, criteria, tag: str):
        """Phase A of a distributed join on every shard: keys, build sort
        and per-probe match ranges (K3); one host sync over the shards'
        match totals picks the one output capacity for all."""
        def run():
            out = []
            for s, pp in enumerate(probe.shards):
                pb = self._build_for(build, s)
                pk, bk, pv, bv, pairs, verify = self._join_keys(pp, pb, criteria)
                probe_live = pp.mask if pv is None else (pp.mask & pv)
                build_live = pb.mask if bv is None else (pb.mask & bv)
                order, lo, cnt = K.join_ranges(bk, build_live, pk, probe_live)
                out.append((pb, order, lo, cnt, pairs, verify))
            return out

        phases = self._attempt(tag, run)
        totals = self._sync([K.blocked_sum(ph[3]) for ph in phases])
        return phases, pad_capacity(int(max(totals.max(), 1)))

    def _equi_join_sharded(self, node, probe: ShardedPage, build, replicated: bool,
                           kind: str, criteria, out_syms) -> ShardedPage:
        p_cap = probe.shard_capacity
        b_cap = build.shard_capacity if not replicated else build.capacity
        first_b = build.shards[0] if not replicated else build
        p_cols = dict(zip(probe.names, probe.shards[0].columns))
        b_cols = dict(zip(first_b.names, first_b.columns))
        phases, out_cap = self._join_count_sharded(
            probe, build, criteria, "join-count")

        # reserve the per-shard join working set (probe shard + build +
        # expansion output) through the memory context
        def lane_bytes(cols):
            return sum((2 if c.data.dim() == 2 else 1) * 8 for c in cols)

        out_row = sum(
            (2 if (p_cols.get(s) or b_cols[s]).data.dim() == 2 else 1) * 8
            for s in out_syms
        )
        working_set = (
            p_cap * lane_bytes(p_cols.values())
            + b_cap * lane_bytes(b_cols.values())
            + out_cap * (out_row + 8)
        )
        ctx = self.memory_ctx.child("mesh-join")
        ctx.reserve(working_set)
        ctx.free(working_set)

        out_meta = [(s, s in p_cols) for s in out_syms]
        fsyms = sorted(_expr_symbols(node.filter)) if node.filter is not None else []
        filters: dict = {}

        def run():
            shards = []
            for pp, (pb, order, lo, cnt, pairs, verify) in zip(probe.shards, phases):
                probe_idx, build_idx, out_live = self._expand_verified(
                    order, lo, cnt, out_cap, pairs, verify)
                penv, benv = self._env(pp), self._env(pb)
                inner = {}
                for s, from_probe in out_meta:
                    d, v = (penv if from_probe else benv)[s]
                    idx = probe_idx if from_probe else build_idx
                    inner[s] = (d[idx], None if v is None else v[idx])
                if node.filter is not None:
                    dev = pp.mask.device
                    if dev not in filters:
                        filters[dev] = compile_expr(
                            node.filter, _pair_layout(pp, pb, dev))
                    fenv = _gather_pair_env(
                        penv, benv, set(pp.names), fsyms, probe_idx, build_idx,
                        base=inner)
                    fd, fv = filters[dev].fn(fenv)
                    out_live = out_live & (fd if fv is None else (fd & fv))
                sections = {s: [inner[s]] for s, _ in out_meta}
                masks = [out_live]
                if kind in ("left", "full"):
                    matched = K.range_any(cnt, out_live)
                    for s, from_probe in out_meta:
                        sections[s].append(
                            penv[s] if from_probe
                            else _null_section(benv[s][0], p_cap))
                    masks.append(pp.mask & ~matched)
                if kind == "full":
                    bmatched = K.scatter_any(build_idx, out_live, b_cap)
                    for s, from_probe in out_meta:
                        sections[s].append(
                            _null_section(penv[s][0], b_cap) if from_probe
                            else benv[s])
                    masks.append(pb.mask & ~bmatched)
                cols = []
                for s, from_probe in out_meta:
                    src = p_cols[s] if from_probe else b_cols[s]
                    data, valid = _concat_sections(sections[s])
                    cols.append(Column(node.outputs[s], data, valid,
                                       src.dictionary, src.hash_pool))
                shards.append(Page(list(out_syms), cols, torch.cat(masks)))
            return shards

        return ShardedPage(list(out_syms), self._attempt("join-expand", run))

    def _dist_cross(self, node: P.Join) -> ShardedPage:
        probe = self.execute_dist(node.left)
        build = self._broadcast_page(node.right)
        nb = build.num_rows()
        live = self._sync([K.count_true(m) for m in probe.masks])
        out_cap = pad_capacity(max(int(live.max()) * nb, 1))
        out_syms = list(node.outputs)
        shards = []
        for s, pp in enumerate(probe.shards):
            pb = self._build_for(build, s)
            dev = pp.mask.device
            perm = torch.sort((~pp.mask).to(torch.int8), stable=True).indices
            j = torch.arange(out_cap, dtype=I64, device=dev)
            li = perm[(j // max(nb, 1)).clamp(0, pp.capacity - 1)]
            ri = (j % max(nb, 1)).clamp(0, pb.capacity - 1)
            cols = []
            for sym in out_syms:
                from_probe = sym in pp.names
                c = (pp if from_probe else pb).column(sym)
                idx = li if from_probe else ri
                cols.append(Column(
                    node.outputs[sym], c.data[idx],
                    None if c.valid is None else c.valid[idx],
                    c.dictionary, c.hash_pool))
            shards.append(Page(out_syms, cols, j < int(live[s]) * nb))
        return ShardedPage(out_syms, shards)

    # ---- distributed semi join ------------------------------------------

    def _dist_semi(self, node: P.SemiJoin) -> ShardedPage:
        sp = self.execute_dist(node.source)
        filt = self._broadcast_page(node.filter_source)
        self._unify_key_dicts(sp, filt, node.keys)
        key_nullable = any(
            sp.column(a).valid is not None for a, _ in node.keys
        ) or any(filt.column(b).valid is not None for _, b in node.keys)
        if node.null_aware and key_nullable:
            # 3VL NULL semantics need global build-NULL knowledge: run the
            # single-device path on gathered rows, then re-shard
            return self.scatter(self._semi_join_pages(node, self.gather(sp), filt))
        criteria = list(node.keys)
        if len(criteria) > 1 or node.filter is not None or any(
            sp.column(a).data.dim() == 2 and sp.column(a).hash_pool is None
            for a, _ in criteria
        ):
            # semiB: expand, verify, residual filter, then K5 per probe
            phases, out_cap = self._join_count_sharded(
                sp, filt, criteria, "semi-count")
            filters: dict = {}
            fsyms = (
                sorted(_expr_symbols(node.filter)) if node.filter is not None
                else []
            )

            def run():
                matched = []
                for pp, (pb, order, lo, cnt, pairs, verify) in zip(sp.shards, phases):
                    probe_idx, build_idx, out_live = self._expand_verified(
                        order, lo, cnt, out_cap, pairs, verify)
                    if node.filter is not None:
                        dev = pp.mask.device
                        if dev not in filters:
                            filters[dev] = compile_expr(
                                node.filter, _pair_layout(pp, pb, dev))
                        fenv = _gather_pair_env(
                            self._env(pp), self._env(pb), set(pp.names), fsyms,
                            probe_idx, build_idx)
                        fd, fv = filters[dev].fn(fenv)
                        out_live = out_live & (fd if fv is None else (fd & fv))
                    matched.append(K.range_any(cnt, out_live))
                return matched
        else:
            # semiA: one exact key, no filter: K3's counts suffice
            def run():
                matched = []
                for s, pp in enumerate(sp.shards):
                    pb = self._build_for(filt, s)
                    pk, bk, pv, bv, _, _ = self._join_keys(pp, pb, criteria)
                    probe_live = pp.mask if pv is None else (pp.mask & pv)
                    build_live = pb.mask if bv is None else (pb.mask & bv)
                    _, _, cnt = K.join_ranges(bk, build_live, pk, probe_live)
                    matched.append(cnt > 0)
                return matched

        matched = self._attempt("semi-join", run)
        names = list(sp.names) + [node.match_symbol]
        return ShardedPage(names, [
            Page(names, list(p.columns) + [Column(T.BOOLEAN, m, None, None)],
                 p.mask)
            for p, m in zip(sp.shards, matched)
        ])
