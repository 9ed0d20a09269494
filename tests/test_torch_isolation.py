"""The port stands alone: importing ``repro_torch`` and running a query
pulls in neither jax nor the ``repro`` package (checked in a fresh
interpreter), the generated program imports ``repro_torch.core``, no
module of the port (nor ``chip_smoke.py``) has an import of either, and
the device backend refuses to start without a card unless the caller asks
for the CPU."""
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
eng = Engine(backend="device", device="cpu")
eng.load_edges("Edge", src, dst)
for a in W.ALIASES:
    eng.alias(a, "Edge")
count = int(eng.query(W.TRIANGLE_COUNT).scalar())
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(json.dumps({"count": count, "leaked": leaked,
                  "source": eng.generated_source()}))
"""


def test_port_query_imports_neither_jax_nor_repro():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", PROBE], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         check=True)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["leaked"] == []
    assert res["count"] > 0
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
