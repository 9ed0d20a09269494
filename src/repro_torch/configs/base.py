"""Config-system core, counterpart of ``repro.configs.base``: the shape
and arch records, and the shapes of the archs the port has so far (the
recsys shapes; the LM and GNN shapes come with their models)."""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional


@dataclasses.dataclass(frozen=True)
class ShapeDef:
    name: str
    kind: str                    # train | prefill | decode | score | retrieval
    params: Dict[str, Any]
    skip: Optional[str] = None   # reason string if this cell is N/A


@dataclasses.dataclass
class ArchDef:
    name: str
    family: str                  # lm | gnn | recsys | engine
    tag: str                     # dense | moe | gnn | recsys | engine
    config: Any                  # model config dataclass
    shapes: Dict[str, ShapeDef]
    source: str                  # provenance citation
    notes: str = ""

    def shape(self, name: str) -> ShapeDef:
        return self.shapes[name]


# ------------------------------------------------------------ recsys shapes
def recsys_shapes() -> Dict[str, ShapeDef]:
    return {
        "train_batch": ShapeDef("train_batch", "train", {"batch": 65536}),
        "serve_p99": ShapeDef("serve_p99", "score", {"batch": 512}),
        "serve_bulk": ShapeDef("serve_bulk", "score", {"batch": 262144}),
        "retrieval_cand": ShapeDef("retrieval_cand", "retrieval",
                                   {"batch": 1, "n_candidates": 1_000_000}),
    }
