"""Top-level query engine facade — the port of ``trino_tpu/engine.py``.

SQL in, rows out: parse, analyze, optimize, then execute on one torch
device, or with a ``mesh`` (``parallel.core.make_mesh``) distribution-plan
the statement (``plan.distribute.add_exchanges``) and run it over the
mesh's shards (``exec.mesh.MeshExecutor``; the DistributedQueryRunner
analog). The runner runs on the card (``cuda``) unless the caller asks
for another device; with CUDA absent and no device given it raises
rather than quietly running on the CPU.

Only queries (``SELECT`` / ``WITH`` / ``VALUES``) execute; metadata
statements, EXPLAIN, DDL and DML, the result cache, the performance
sentry and the tracer are not ported yet.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field

import torch

from trino_tpu_torch.analyzer.analyzer import Analyzer
from trino_tpu_torch.connectors.tpch.connector import TpchConnector
from trino_tpu_torch.exec.local import LocalExecutor
from trino_tpu_torch.metadata import Metadata, Session
from trino_tpu_torch.page import Page
from trino_tpu_torch.plan import nodes as P
from trino_tpu_torch.plan.optimizer import optimize
from trino_tpu_torch.sql import ast
from trino_tpu_torch.sql.parser import parse_statement

__all__ = ["QueryRunner", "QueryResult", "resolve_device"]


def resolve_device(device=None) -> torch.device:
    """The device a runner executes on: ``cuda`` unless ``device`` names
    another. With no device given and CUDA absent this raises: there is
    no silent fallback to the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available: pass device='cpu' to run the "
                "engine on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)


@dataclass
class QueryResult:
    names: list[str]
    rows: list[tuple]
    #: True when the query had a top-level ORDER BY (rows are ordered)
    ordered: bool = False
    plan: P.PlanNode | None = field(default=None, repr=False)


class QueryRunner:
    """SQL in, rows out — the LocalQueryRunner analog, on one device."""

    def __init__(
        self,
        metadata: Metadata | None = None,
        session: Session | None = None,
        device=None,
        mesh=None,
    ):
        self.metadata = metadata or Metadata()
        self.session = session or Session()
        self.mesh = mesh
        # statements execute serially per runner: the executor's scan
        # cache and the session are shared mutable state
        self._lock = threading.RLock()
        # one executor across queries keeps scanned tables resident
        if mesh is not None:
            from trino_tpu_torch.exec.mesh import MeshExecutor

            if device is not None and torch.device(device) != mesh.devices[0]:
                raise ValueError(
                    f"device {device} is not the mesh's first device "
                    f"{mesh.devices[0]}")
            self.device = mesh.devices[0]
            self.executor = MeshExecutor(self.metadata, self.session, mesh)
        else:
            self.device = resolve_device(device)
            self.executor = LocalExecutor(
                self.metadata, self.session, self.device)

    @staticmethod
    def tpch(schema: str = "tiny", device=None, mesh=None) -> "QueryRunner":
        """Runner with the TPC-H catalog mounted."""
        md = Metadata()
        md.register_catalog("tpch", TpchConnector())
        return QueryRunner(
            md, Session(catalog="tpch", schema=schema), device=device,
            mesh=mesh,
        )

    @staticmethod
    def tpcds(schema: str = "tiny", device=None, mesh=None) -> "QueryRunner":
        """Runner with the TPC-DS catalog mounted."""
        from trino_tpu_torch.connectors.tpcds.connector import TpcdsConnector

        md = Metadata()
        md.register_catalog("tpcds", TpcdsConnector())
        return QueryRunner(
            md, Session(catalog="tpcds", schema=schema), device=device,
            mesh=mesh,
        )

    # ---- planning --------------------------------------------------------

    def plan_stmt(self, stmt: ast.Statement, optimized: bool = True) -> P.PlanNode:
        """Analyze + optimize one statement."""
        return self._plan_stmt_inner(stmt, optimized)

    def _plan_stmt_inner(
        self, stmt: ast.Statement, optimized: bool = True
    ) -> P.PlanNode:
        analyzer = Analyzer(self.metadata, self.session)
        plan = analyzer.analyze(stmt)
        if optimized:
            plan = optimize(plan, self.metadata, self.session)
            if self.mesh is not None:
                from trino_tpu_torch.plan import validate
                from trino_tpu_torch.plan.distribute import add_exchanges

                plan = add_exchanges(
                    plan, self.metadata, n_shards=self.mesh.devices.size,
                    session=self.session,
                )
                if validate.level(self.session) != "OFF":
                    validate.validate_plan(plan, phase="add_exchanges")
            from trino_tpu_torch.plan.stats import annotate

            plan = annotate(plan, self.metadata, self.session)
        return plan

    def plan_sql(self, sql: str, optimized: bool = True) -> P.PlanNode:
        return self.plan_stmt(parse_statement(sql), optimized=optimized)

    # ---- execution -------------------------------------------------------

    def execute_page(self, sql: str) -> tuple[P.PlanNode, Page]:
        plan = self.plan_sql(sql)
        return plan, self.executor.execute(plan)

    def execute(self, sql: str) -> QueryResult:
        stmt = parse_statement(sql)
        if not isinstance(stmt, ast.Query):
            raise NotImplementedError(
                f"statement {type(stmt).__name__} is not ported"
            )
        with self._lock:
            plan = self.plan_stmt(stmt)
            page = self.executor.execute(plan)
            rows = page.to_pylist()
        return QueryResult(
            names=list(page.names),
            rows=rows,
            ordered=_has_order(plan),
            plan=plan,
        )


def _has_order(plan: P.PlanNode) -> bool:
    node = plan
    while isinstance(node, (P.Output, P.Limit, P.Project)):
        node = node.sources[0]
    return isinstance(node, (P.Sort, P.TopN))
