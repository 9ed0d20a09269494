"""ELL SpMV kernel package: PageRank's ``y = A x`` over any ELL packing
read as one flat run of slots (the CSR itself at width 1), balanced over
row ends and slots by merge-path, with no atomics; equal within float32
rounding to its plain PyTorch version in :mod:`.ref`."""
from repro_torch.kernels.spmv_ell.ops import spmv_ell  # noqa: F401
