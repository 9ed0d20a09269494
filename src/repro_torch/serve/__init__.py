"""Serving layer of the port (counterpart of ``repro.serve``):

* :class:`repro_torch.serve.query.QueryServer` — **relational**:
  parameterized datalog queries over :class:`repro_torch.core.engine.Engine`
  with cached physical plans, batched device execution, and a
  multi-tenant :class:`repro_torch.serve.query.GraphStore` with LRU
  device-cache eviction;
* :func:`repro_torch.serve.engine.batched_scores` — the recsys bulk
  scorer.

The token server waits for the transformer model."""
from repro_torch.serve.engine import batched_scores  # noqa: F401
from repro_torch.serve.query import GraphStore, QueryServer, Ticket  # noqa: F401

__all__ = ["GraphStore", "QueryServer", "Ticket", "batched_scores"]
