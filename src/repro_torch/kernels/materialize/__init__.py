"""Materializing bitset-intersection kernel package (paper Section 4.2 /
Figure 6): every element of ``S_a ∩ S_b`` of the dense cohort with its
rank in both sets, count then fill over matched block pairs, equal to its
plain PyTorch version in :mod:`.ref`."""
from repro_torch.kernels.materialize.ops import bitset_pair_materialize  # noqa: F401
