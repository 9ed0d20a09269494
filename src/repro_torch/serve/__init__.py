"""Serving layer of the port (counterpart of ``repro.serve``): so far the
recsys bulk scorer :func:`repro_torch.serve.engine.batched_scores`.  The
token server waits for the transformer model, the relational
``QueryServer`` for the engine's batched path."""
from repro_torch.serve.engine import batched_scores  # noqa: F401
