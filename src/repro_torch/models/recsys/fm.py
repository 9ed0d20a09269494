"""Factorization Machine (Rendle, ICDM'10); counterpart of
``repro.models.recsys.fm``.

logit(x) = w0 + sum_i w_i x_i + sum_{i<j} <v_i, v_j> x_i x_j, with the
second-order term computed by the O(nk) sum-square trick in the CUDA
kernel ``repro_torch.kernels.fm_interaction`` for tensors on the card and
its plain version for tensors on the CPU: the device decides, there is no
other switch.

The functions take a params dict ``{"emb" [F*V, D], "w_lin" [F*V],
"w0" []}``, as the reference does; field f's row v lives at f * V + v.
Ids stay int32 (the full table's 39,000,000 rows fit).  Every lookup
follows the reference's ``jnp.take``: a row in ``[-rows, 0)`` wraps, a
row outside ``[-rows, rows)`` reads NaN, and a per-field id past V reads
the later field's row it lands on.  The gather clamps the index and the
NaN is written where the index was invalid, with no host sync.

On the card ``forward`` and ``retrieval_scores`` run under
``torch.inference_mode()``: the kernel has no backward yet, so ``loss_fn``
there gives a value without a gradient.  On the CPU everything stays
differentiable.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.kernels import common
from repro_torch.kernels.fm_interaction import ops as fm_ops


@dataclasses.dataclass(frozen=True)
class FMConfig:
    name: str
    n_sparse: int = 39           # number of categorical fields
    vocab_per_field: int = 100_000
    embed_dim: int = 10
    interaction: str = "fm-2way"
    dtype: Any = torch.float32

    @property
    def total_rows(self) -> int:
        return self.n_sparse * self.vocab_per_field

    def param_count(self) -> int:
        return self.total_rows * (self.embed_dim + 1) + 1


def init(cfg: FMConfig, generator: torch.Generator, device=None):
    """N(0, 1) * 0.01 for ``emb`` and ``w_lin``, zero ``w0``, drawn with
    ``generator``, which must live on the device the tensors go to
    (``cuda`` unless ``device`` names another)."""
    dev = common.default_device(device, "fm.init")
    if generator.device.type != dev.type:
        raise ValueError(f"generator on {generator.device}, tensors on {dev}")

    def normal(*shape):
        return torch.randn(shape, generator=generator, dtype=cfg.dtype,
                           device=dev).mul_(0.01)

    return {"emb": normal(cfg.total_rows, cfg.embed_dim),
            "w_lin": normal(cfg.total_rows),
            "w0": torch.zeros((), dtype=cfg.dtype, device=dev)}


def params_from_reference(params_np, device=None):
    """The reference's ``{"emb", "w_lin", "w0"}`` arrays (numpy, or
    anything ``np.asarray`` takes) as the port's tensors on ``device``
    (``cuda`` unless it names another), so both packages compute the same
    function."""
    dev = common.default_device(device, "fm.params_from_reference")
    return {k: torch.as_tensor(np.asarray(params_np[k]), device=dev)
            for k in ("emb", "w_lin", "w0")}


def param_axes(cfg: FMConfig):
    return {"emb": ("table_rows", "embed"), "w_lin": ("table_rows",),
            "w0": ()}


def _ids(ids, device) -> torch.Tensor:
    return torch.as_tensor(ids, device=device).to(torch.int32)


def _global_ids(ids: torch.Tensor, cfg: FMConfig) -> torch.Tensor:
    """Per-field ids [B, F] -> rows in the fused table."""
    field_base = torch.arange(cfg.n_sparse, dtype=ids.dtype,
                              device=ids.device) * cfg.vocab_per_field
    return ids + field_base[None, :]


def _checked(idx: torch.Tensor, n: int):
    """``jnp.take``'s index rule for a table of ``n`` rows: the index to
    gather (an invalid one reads row 0 here) and the mask of valid
    indices; the caller writes NaN where the mask is False."""
    idx = torch.where(idx < 0, idx + n, idx)
    valid = (idx >= 0) & (idx < n)
    return torch.where(valid, idx, 0), valid


def _rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table`` rows at a checked ``idx``, shaped ``idx.shape + row``."""
    rows = table.index_select(0, idx.reshape(-1))
    return rows.view(*idx.shape, *table.shape[1:])


def _nan_unless(x: torch.Tensor, ok: torch.Tensor) -> torch.Tensor:
    return x.masked_fill(~ok, float("nan"))


def embedding_bag(table, bag_ids, bag_segments, num_bags: int,
                  combiner: str = "sum"):
    """EmbeddingBag: rows = table[bag_ids]; reduce rows per bag.

    bag_ids [M] row indices, bag_segments [M] bag index per id (sorted).
    A segment outside ``[0, num_bags)`` is dropped, as
    ``jax.ops.segment_sum`` drops it.
    """
    idx, valid = _checked(_ids(bag_ids, table.device), table.shape[0])
    rows = _nan_unless(_rows(table, idx), valid[:, None])
    seg = torch.as_tensor(bag_segments, device=table.device).long()
    # dropped ids go to a spare bag past the last one
    seg = torch.where((seg >= 0) & (seg < num_bags), seg, num_bags)
    out = rows.new_zeros((num_bags + 1, table.shape[1])) \
        .index_add_(0, seg, rows)[:num_bags]
    if combiner == "mean":
        cnt = rows.new_zeros(num_bags + 1).index_add_(
            0, seg, rows.new_ones(seg.shape[0]))[:num_bags]
        out = out / torch.clamp(cnt, min=1.0)[:, None]
    return out


def forward(params, batch, cfg: FMConfig):
    """batch["ids"]: [B, F] single-hot field ids -> logits [B]."""
    emb = params["emb"]
    with torch.inference_mode(emb.is_cuda):
        ids = _global_ids(_ids(batch["ids"], emb.device), cfg)
        idx, valid = _checked(ids, emb.shape[0])
        inter = fm_ops.fm_interaction(_rows(emb, idx))     # [B, F, D]
        lin = _rows(params["w_lin"], idx).sum(dim=1)
        logits = params["w0"] + lin + inter.to(cfg.dtype)
        # an invalid row makes the reference's emb and w_lin NaN, and so
        # its logit
        return _nan_unless(logits, valid.all(dim=1))


def loss_fn(params, batch, cfg: FMConfig):
    logits = forward(params, batch, cfg).to(torch.float32)
    y = torch.as_tensor(batch["label"], device=logits.device)
    loss = torch.mean(torch.clamp(logits, min=0) - logits * y
                      + torch.log1p(torch.exp(-logits.abs())))
    return loss, {"bce": loss}


def retrieval_scores(params, user_ids, cand_ids, cfg: FMConfig):
    """Score one multi-hot user query against N candidates: FM reduces to
    dot(user_vec_sum, cand_emb) + linear terms (one float32 ``torch.mv``,
    not a loop).

    user_ids [Fu] global rows; cand_ids [N] global rows.
    """
    emb = params["emb"]
    with torch.inference_mode(emb.is_cuda):
        n = emb.shape[0]
        u_idx, u_ok = _checked(_ids(user_ids, emb.device), n)
        u = _nan_unless(_rows(emb, u_idx).sum(dim=0), u_ok.all())  # [D]
        c_idx, c_ok = _checked(_ids(cand_ids, emb.device), n)
        scores = torch.mv(_rows(emb, c_idx), u) \
            + _rows(params["w_lin"], c_idx)
        return _nan_unless(scores, c_ok)

