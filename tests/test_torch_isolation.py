"""The port stands alone: it loads no JAX and no module of the JAX
package, runs on the card unless asked for the CPU, and generates the
same TPC-H and TPC-DS data as the reference."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent


def _forbidden(module: str) -> bool:
    # "trino_tpu." with the dot: trino_tpu_torch is the port itself
    return (
        module in ("jax", "jaxlib", "trino_tpu")
        or module.startswith(("jax.", "jaxlib.", "trino_tpu."))
    )


def test_running_a_query_loads_no_jax_or_reference_module():
    code = (
        "import sys\n"
        "import trino_tpu_torch\n"
        "from trino_tpu_torch.engine import QueryRunner\n"
        "from trino_tpu_torch.connectors.tpch.queries import QUERIES\n"
        "from trino_tpu_torch.connectors.tpcds.queries import QUERIES as DS\n"
        "r = QueryRunner.tpch('tiny', device='cpu')\n"
        "assert len(r.execute(QUERIES['q01']).rows) == 4\n"
        "ds = QueryRunner.tpcds('tiny', device='cpu')\n"
        "assert len(ds.execute(DS['q86']).rows) == 100\n"
        "print('\\n'.join(sorted(sys.modules)))\n"
    )
    env = dict(os.environ)
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    loaded = out.stdout.split()
    assert "trino_tpu_torch.engine" in loaded
    assert [m for m in loaded if _forbidden(m)] == []


def test_spill_tier_loads_no_jax_or_reference_module():
    """The budgeted and revoked paths (``exec/spill.py``, the split of
    ``plan/distribute.py``) load nothing of JAX either."""
    code = (
        "import sys\n"
        "from trino_tpu_torch.engine import QueryRunner\n"
        "from trino_tpu_torch.exec import spill\n"
        "spill.MIN_CHUNK_ROWS = 8192\n"
        "r = QueryRunner.tpch('tiny', device='cpu')\n"
        "r.session.properties['hbm_budget_bytes'] = 1 << 20\n"
        "r.execute('select l_returnflag, approx_distinct(l_partkey), "
        "approx_percentile(l_quantity, 0.5) from lineitem group by 1')\n"
        "r = QueryRunner.tpch('tiny', device='cpu')\n"
        "r.session.properties['query_max_memory_per_node'] = str(2 << 20)\n"
        "r.execute('select count(*) from lineitem l1, lineitem l2 where "
        "l1.l_orderkey = l2.l_orderkey and l1.l_linenumber = l2.l_linenumber')\n"
        "assert r.executor.memory_revocations >= 1\n"
        "assert spill.ENTRIES['run_chain_streamed'] >= 1\n"
        "print('\\n'.join(sorted(sys.modules)))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=dict(os.environ),
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    loaded = out.stdout.split()
    assert "trino_tpu_torch.exec.spill" in loaded
    assert "trino_tpu_torch.plan.distribute" in loaded
    assert [m for m in loaded if _forbidden(m)] == []


def test_mesh_loads_no_jax_or_reference_module():
    """The device mesh (``parallel/``, ``exec/mesh.py``, the distribution
    planner, the memory connector and the fault injector) loads nothing
    of JAX either."""
    code = (
        "import sys\n"
        "import numpy as np\n"
        "from trino_tpu_torch import types as T\n"
        "from trino_tpu_torch.connectors.base import TableSchema\n"
        "from trino_tpu_torch.connectors.memory import MemoryConnector\n"
        "from trino_tpu_torch.engine import QueryRunner\n"
        "from trino_tpu_torch.metadata import Metadata, Session\n"
        "from trino_tpu_torch.parallel import make_mesh\n"
        "from trino_tpu_torch.parallel.groupby import q1_step\n"
        "r = QueryRunner.tpch('tiny', mesh=make_mesh(8, device='cpu'))\n"
        "assert len(r.execute('select l_returnflag, count(*) from lineitem "
        "group by 1 order by 1').rows) == 3\n"
        "assert r.executor.exchange_stats['exchanges'] >= 2\n"
        "md = Metadata()\n"
        "md.register_catalog('memory', MemoryConnector())\n"
        "md.connector('memory').create_table('default', 't', "
        "TableSchema('t', [('k', T.BIGINT)]))\n"
        "md.connector('memory').insert('default', 't', "
        "{'k': np.arange(10, dtype=np.int64)})\n"
        "m = QueryRunner(md, Session(catalog='memory', schema='default'), "
        "mesh=make_mesh(4, device='cpu'))\n"
        "assert m.execute('select sum(k) from t').rows == [(45,)]\n"
        "print('\\n'.join(sorted(sys.modules)))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=dict(os.environ),
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    loaded = out.stdout.split()
    for m in ("trino_tpu_torch.exec.mesh", "trino_tpu_torch.parallel.exchange",
              "trino_tpu_torch.parallel.groupby", "trino_tpu_torch.fault",
              "trino_tpu_torch.exec.failure",
              "trino_tpu_torch.connectors.memory"):
        assert m in loaded, m
    assert [m for m in loaded if _forbidden(m)] == []


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_sources_import_no_jax_or_reference_module():
    files = sorted((REPO / "trino_tpu_torch").rglob("*.py"))
    files += [REPO / "chip_smoke.py", REPO / "kernel_ab.py"]
    assert len(files) > 20
    bad = [
        (str(p.relative_to(REPO)), m)
        for p in files for m in _imports(p) if _forbidden(m)
    ]
    assert bad == []


def test_runner_without_device_raises_when_cuda_is_absent(monkeypatch):
    from trino_tpu_torch.engine import QueryRunner

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        QueryRunner.tpch("tiny")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        QueryRunner.tpcds("tiny")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        QueryRunner()
    from trino_tpu_torch.parallel import make_mesh

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_mesh(8)
    assert make_mesh(8, device="cpu").devices.size == 8
    assert QueryRunner.tpch("tiny", device="cpu").device.type == "cpu"
    assert QueryRunner.tpcds("tiny", device="cpu").device.type == "cpu"


@pytest.mark.parametrize("table", ["lineitem", "orders", "customer"])
def test_generator_columns_are_byte_identical(table):
    from trino_tpu.connectors.tpch.generator import SCHEMAS, TpchData as JaxData
    from trino_tpu_torch.connectors.tpch.generator import TpchData as TorchData

    want, got = JaxData(0.01), TorchData(0.01)
    for column in SCHEMAS[table].column_names:
        a, b = got.column(table, column), want.column(table, column)
        assert a.dtype == b.dtype, column
        if a.dtype == object:
            assert np.array_equal(a.astype(str), b.astype(str)), column
        else:
            assert a.tobytes() == b.tobytes(), column


@pytest.mark.parametrize(
    "table", ["store_sales", "web_sales", "item", "date_dim", "customer"]
)
def test_tpcds_generator_columns_are_byte_identical(table):
    from trino_tpu.connectors.tpcds.generator import SCHEMAS, TpcdsData as JaxData
    from trino_tpu_torch.connectors.tpcds.generator import TpcdsData as TorchData

    want, got = JaxData(0.01), TorchData(0.01)
    for column in SCHEMAS[table].column_names:
        a, b = got.column(table, column), want.column(table, column)
        assert a.dtype == b.dtype, column
        if a.dtype == object:
            assert np.array_equal(a.astype(str), b.astype(str)), column
        else:
            assert a.tobytes() == b.tobytes(), column
