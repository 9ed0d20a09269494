from repro_torch.kernels.uint_intersect.ops import intersect_count_csr  # noqa: F401
