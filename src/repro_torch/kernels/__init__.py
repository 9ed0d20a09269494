"""Hand-written CUDA kernels for the engine's hot spots.

Each package is ``ops.py`` (the wrapper: checks, allocation, launch of
the CUDA source under ``repro_torch/csrc/``, launch counter) and
``ref.py`` (the plain PyTorch version the wrapper takes for CPU tensors,
and the on-card oracle):

  frontier_fill     count-then-fill extension pipeline, fill stage, and
                    the device terminal fold (``fold``)
  bitset_intersect  paper §4.2 BITSET∩BITSET — AND + __popc
  uint_intersect    paper §4.2 UINT∩UINT     — warp-per-pair search
"""
