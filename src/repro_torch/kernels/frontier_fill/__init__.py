"""Frontier-fill kernel package: the fill stage of the zero-sync
count-then-fill extension pipeline as one launch over a static slot
window (offset inversion -> seed gather -> branch-free lockstep probes),
and the device terminal fold as one launch over the frontier rows, each
equal to its plain PyTorch version in :mod:`.ref`."""
from repro_torch.kernels.frontier_fill.ops import fill, fold  # noqa: F401
