from repro_torch.kernels.bitset_intersect.ops import bitset_and_popcount  # noqa: F401
