"""Plain PyTorch versions of the FM interaction kernel (the CPU path and
the on-card oracle), both formulations of
``repro.kernels.fm_interaction.ref``; each computes in its input's
dtype, on its input's device."""
from __future__ import annotations

import torch


def fm_interaction_ref(emb: torch.Tensor) -> torch.Tensor:
    """Sum-square formulation (what the kernel computes):
    ``0.5 * sum_d((sum_f e)^2 - sum_f e^2)`` per row of ``[B, F, D]``."""
    s = emb.sum(dim=1)
    sq = (emb * emb).sum(dim=1)
    return 0.5 * (s * s - sq).sum(dim=1)


def fm_interaction_pairwise_ref(emb: torch.Tensor) -> torch.Tensor:
    """Naive O(F^2) pairwise formulation: the independent oracle."""
    g = torch.einsum("bfd,bgd->bfg", emb, emb)
    total = g.sum(dim=(1, 2))
    diag = torch.einsum("bfd,bfd->b", emb, emb)
    return 0.5 * (total - diag)


def fm_interaction_scale(emb: torch.Tensor) -> torch.Tensor:
    """``0.5 * sum_d((sum_f |e|)^2 + sum_f e^2)`` per row: the size of the
    terms the sum-square form cancels, against which two orders of the
    same sums are compared (the result itself may lie near 0)."""
    s = emb.abs().sum(dim=1)
    return 0.5 * (s * s + (emb * emb).sum(dim=1)).sum(dim=1)
