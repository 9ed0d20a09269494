"""FM interaction kernel package: the Factorization Machine's second-order
term by the sum-square trick, ``0.5 * sum_d((sum_f e)^2 - sum_f e^2)``
over ``[B, F, D]``, equal within float32 rounding to its plain PyTorch
version in :mod:`.ref`."""
from repro_torch.kernels.fm_interaction.ops import fm_interaction  # noqa: F401
