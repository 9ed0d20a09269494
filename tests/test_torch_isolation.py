"""The port stands alone: importing ``repro_torch`` and running a query
(with plan verification and the dispatch sanitizer), a materializing
query, ``explain``, ``triangle_count_dense``, ``recursion.pagerank`` and
the FM serving path (``forward``, ``batched_scores``,
``retrieval_scores``), the relational serving path (``QueryServer``
batches, the memory model) and the preprocessing path (Kronecker graph,
statistics, ordering, pruning, dictionary encoding, a query in layout
mode "uint") pulls in neither jax nor the ``repro`` package
(checked in a fresh interpreter), the generated program imports
``repro_torch.core``, no module of the port (nor ``chip_smoke.py``) has an
import of either, and every entry point runs on the card — and refuses to
start without one — unless the caller asks for the CPU."""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent

PROBE = """
import json, sys
import numpy as np
from repro_torch.core import workload as W
from repro_torch.core.engine import Engine
from repro_torch.data.graphs import edge_list, powerlaw_graph
src, dst = edge_list(powerlaw_graph(200, 6, 2.0, seed=1))
eng = Engine(backend="device", device="cpu", sanitize=True)
eng.load_edges("Edge", src, dst)
for a in W.ALIASES:
    eng.alias(a, "Edge")
count = int(eng.query(W.TRIANGLE_COUNT).scalar())
source = eng.generated_source()
rows = eng.query("TY(x,y) :- R(x,y),S(y,z),T(x,z).").num_rows
summary = eng.dispatch_summary()
assert summary["intersect.materialize_kernel"] > 0, summary
assert summary["analysis.plans_verified"] >= 2, summary
assert summary["analysis.sanitize_checks"] >= 2, summary
assert "bag[R(x,y), S(y,z), T(x,z)]" in eng.explain(
    "TY(x,y) :- R(x,y),S(y,z),T(x,z).")
from repro_torch.graph.prune import prune_symmetric, symmetrize
from repro_torch.kernels import triangle_count_dense
from repro_torch.kernels.triangle_mm.ops import densify_csr
pruned = prune_symmetric(symmetrize(src, dst, n=200))
tri = triangle_count_dense(densify_csr(pruned.offsets, pruned.neighbors,
                                       200), symmetric=False, device="cpu")
assert int(tri) * 6 == count, (int(tri), count)
from repro_torch.core import recursion
from repro_torch.core.backend import DeviceBackend
ranks = recursion.pagerank(powerlaw_graph(200, 6, 2.0, seed=1), iters=3,
                           backend=DeviceBackend(device="cpu"))
assert ranks.shape == (200,)
from repro_torch.configs import get_arch
from repro_torch.data import RecsysBatchGen
from repro_torch.models.recsys import fm
from repro_torch.serve import batched_scores
import dataclasses, torch
cfg = dataclasses.replace(get_arch("fm").config, vocab_per_field=100)
params = fm.init(cfg, torch.Generator().manual_seed(0), device="cpu")
batch = RecsysBatchGen(cfg.n_sparse, 100, 64, seed=0).batch_at(0)
logits = fm.forward(params, batch, cfg)
bulk = batched_scores(lambda c: fm.forward(params, c, cfg),
                      {"ids": batch["ids"]}, 16)
assert np.array_equal(bulk, logits.numpy()), (bulk, logits)
scores = fm.retrieval_scores(params, np.arange(16), np.arange(500), cfg)
assert scores.shape == (500,) and bool(torch.isfinite(scores).all())
from repro_torch.analysis.memory_budget import check_store
from repro_torch.serve import QueryServer
srv = QueryServer(device="cpu", max_graphs=1)
for tenant in ("a", "b"):
    srv.load_graph(tenant, "Edge", src, dst)
    for a in W.ALIASES:
        srv.alias(tenant, a, "Edge")
q = "C(;w:long) :- R(0,y),S(y,z),T(0,z); w=<<COUNT(*)>>."
tickets = [srv.submit("a", q, v) for v in range(4)]
srv.drain()
srv.run("b", q, 1)
assert srv.dispatch_summary()["pipeline.batched_launches"] >= 1
assert srv.counters["store.evictions"] == 1, srv.counters
check_store(srv)
from repro_torch.core import layouts
from repro_torch.data import kronecker_graph
from repro_torch.graph import (apply_ordering, encode_edges, graph_stats,
                               order_nodes)
g0 = powerlaw_graph(200, 6, 2.0, seed=1)
ordered = prune_symmetric(apply_ordering(g0, order_nodes(g0, "hybrid")))
assert graph_stats(kronecker_graph(8, 8, seed=0))["edges"] > 0
enc_src, enc_dst, dictionary = encode_edges(*edge_list(ordered))
layouts.set_engine_layout_mode("uint")
try:
    ueng = Engine(backend="device", device="cpu")
    ueng.load_edges("Edge", enc_src, enc_dst)
    for a in W.ALIASES:
        ueng.alias(a, "Edge")
    pruned_count = int(ueng.query(W.TRIANGLE_COUNT).scalar())
finally:
    layouts.set_engine_layout_mode("set")
assert pruned_count * 6 == count, (pruned_count, count)
assert ueng.dispatch_summary()["intersect.uint_kernel"] > 0
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(json.dumps({"count": count, "rows": rows, "leaked": leaked,
                  "source": source}))
"""


def test_port_query_imports_neither_jax_nor_repro():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", PROBE], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         check=True)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["leaked"] == []
    assert res["count"] > 0
    assert res["rows"] > 0
    assert "from repro_torch.core.gj import GenericJoin" in res["source"]
    assert "from repro." not in res["source"]


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_no_port_module_imports_jax_or_repro():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    names = {p.relative_to(ROOT).as_posix() for p in files}
    assert {f"src/repro_torch/{m}.py" for m in (
        "analysis/plan_verify", "analysis/kernel_check",
        "kernels/materialize/ops", "kernels/triangle_mm/ops",
        "kernels/fm_interaction/ops", "models/recsys/fm", "data/recsys",
        "serve/engine", "configs/fm", "serve/query",
        "analysis/memory_budget", "analysis/concurrency_lint",
        "graph/ordering", "graph/dictionary", "graph/stats")} <= names
    assert len(files) > 20
    for path in files:
        for mod in _imports(path):
            assert mod.split(".")[0] not in ("jax", "jaxlib", "repro"), \
                (path, mod)


def test_device_backend_needs_a_card(monkeypatch):
    from repro_torch.core.backend import DeviceBackend
    from repro_torch.core.engine import Engine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        DeviceBackend()
    with pytest.raises(RuntimeError, match="CUDA"):
        Engine(backend="device")
    assert DeviceBackend(device="cpu").device.type == "cpu"


def test_entry_points_default_to_the_card(monkeypatch):
    """With no backend and no device named, the engine, the join, the
    recursion entry points, ``fm.init`` and the query server go to
    ``cuda`` and raise without a card; the CPU is taken only when asked
    for."""
    from repro_torch.core import recursion
    from repro_torch.core.backend import (DeviceBackend, NumpyBackend,
                                          make_backend)
    from repro_torch.core.engine import Engine
    from repro_torch.core.gj import GenericJoin
    from repro_torch.core.trie import CSRGraph, Trie
    from repro_torch.models.recsys import fm
    from repro_torch.serve import QueryServer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    csr = CSRGraph.from_edges([0, 1], [1, 0])
    edge = Trie.build("E", ("x", "y"), [[0, 1], [1, 0]])
    for call in (lambda: make_backend(None), Engine,
                 lambda: GenericJoin([(edge, ("x", "y"))], ("x", "y"),
                                     ("x", "y")),
                 lambda: recursion.pagerank(csr),
                 lambda: recursion.sssp(csr, 0),
                 lambda: fm.init(fm.FMConfig(name="t", vocab_per_field=5),
                                 torch.Generator()),
                 QueryServer):
        with pytest.raises(RuntimeError, match="needs a CUDA device"):
            call()
    assert isinstance(make_backend("numpy"), NumpyBackend)
    assert Engine(device="cpu").backend.device.type == "cpu"
    assert QueryServer(device="cpu").backend.device.type == "cpu"
    assert isinstance(make_backend(None, device="cpu"), DeviceBackend)
    assert recursion.pagerank(csr, device="cpu").shape == (2,)
    assert recursion.sssp(csr, 0, device="cpu").tolist() == [0.0, 1.0]


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """Alone in a directory, or on a machine without a card, the chip
    smoke script exits non-zero and prints no result line."""
    script = ROOT / "chip_smoke.py"
    alone = tmp_path / "chip_smoke.py"
    alone.write_text(script.read_text())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    # in the checkout it would run in full on a machine with a card
    cwds = [tmp_path] + ([] if torch.cuda.is_available() else [ROOT])
    for cwd in cwds:
        out = subprocess.run([sys.executable, str(cwd / "chip_smoke.py")],
                             env=env, cwd=cwd, capture_output=True,
                             text=True, timeout=300)
        assert out.returncode != 0
        assert '"ok": true' not in out.stdout
