"""Dense triangle-count kernel package: ``sum((A @ A) * A)`` over a 0/1
adjacency as a tiled product with a masked reduction, exact, equal to its
plain PyTorch version in :mod:`.ref`."""
from repro_torch.kernels.triangle_mm.ops import (  # noqa: F401
    densify_csr, triangle_count_dense)
