"""Hand-written CUDA kernels for the engine's hot spots.

Each package is ``ops.py`` (the wrapper: checks, allocation, launch of
the CUDA source under ``repro_torch/csrc/``, launch counter) and
``ref.py`` (the plain PyTorch version the wrapper takes for CPU tensors,
and the on-card oracle):

  frontier_fill     count-then-fill extension pipeline, fill stage, and
                    the device terminal fold (``fold``)
  bitset_intersect  paper §4.2 BITSET∩BITSET — AND + __popc
  uint_intersect    paper §4.2 UINT∩UINT     — warp-per-pair search
  spmv_ell          PageRank's SpMV over the CSR (or any ELL packing) —
                    merge-path blocks over row ends and slots, a
                    segmented scan, a fix-up of rows crossing blocks
  materialize       paper §4.2/Fig 6 materializing BITSET∩BITSET — count
                    then fill, a warp per matched block pair, popcount
                    ranks
  triangle_mm       dense-cohort triangle count sum((A@A)*A) — tiled
                    float32 product, masked integer reduction
  fm_interaction    the Factorization Machine's second-order term by the
                    sum-square trick — a lane group per row's columns,
                    several rows a warp
"""
from repro_torch.kernels.fm_interaction.ops import fm_interaction  # noqa: F401
from repro_torch.kernels.triangle_mm.ops import triangle_count_dense  # noqa: F401
