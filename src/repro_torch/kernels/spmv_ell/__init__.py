"""ELL SpMV kernel package: PageRank's ``y = A x`` over fixed-width ELL
rows, long CSR rows split over consecutive ELL rows and summed per vertex
in a second deterministic pass; equal within float32 rounding to its
plain PyTorch version in :mod:`.ref`."""
from repro_torch.kernels.spmv_ell.ops import spmv_ell  # noqa: F401
