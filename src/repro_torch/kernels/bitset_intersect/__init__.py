from repro_torch.kernels.bitset_intersect.ops import (  # noqa: F401
    bitset_and_popcount, bitset_pair_count)
