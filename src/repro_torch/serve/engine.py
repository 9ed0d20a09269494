"""Model serving, counterpart of ``repro.serve.engine``: so far the
offline bulk scorer of the recsys serve_bulk path."""
from __future__ import annotations

from collections.abc import Callable

import torch

from repro_torch.kernels import common


def batched_scores(score_fn: Callable, inputs, batch: int):
    """Offline bulk scoring: run ``score_fn`` over ``inputs`` (an array or
    tensor, or a dict of them, all of one length) in chunks of ``batch``
    rows, under ``torch.inference_mode()``, and return the scores as one
    numpy array.  The chunks' scores stay where ``score_fn`` puts them and
    come to the host in one transfer."""
    def chunk(s):
        if isinstance(inputs, dict):
            return {k: v[s:s + batch] for k, v in inputs.items()}
        return inputs[s:s + batch]

    first = next(iter(inputs.values())) if isinstance(inputs, dict) \
        else inputs
    with torch.inference_mode():
        outs = [torch.as_tensor(score_fn(chunk(s)))
                for s in range(0, len(first), batch)]
        return common.host_get(torch.cat(outs))
