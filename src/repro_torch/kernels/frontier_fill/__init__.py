"""Frontier-fill kernel package: the fill stage of the zero-sync
count-then-fill extension pipeline as one launch over a static slot
window (offset inversion -> seed gather -> branch-free lockstep probes),
and the device terminal fold as one launch over the frontier rows, each
equal to its plain PyTorch version in :mod:`.ref`; and the batched forms
of both, one launch for B queries over the same levels."""
from repro_torch.kernels.frontier_fill.ops import (  # noqa: F401
    fill, fill_batched, fold, fold_batched)
