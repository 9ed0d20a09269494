"""fm [recsys] — n_sparse=39 embed_dim=10 interaction=fm-2way.
[ICDM'10 (Rendle); paper]

Embedding tables: 39 fields x 1M rows x dim 10 (the 10^6-row-per-field
regime), one fused [39M, 10] float32 table of 1.56 GB on the card.  The
FM interaction is the CUDA ``fm_interaction`` kernel (sum-square trick).
"""
from repro_torch.configs.base import ArchDef, recsys_shapes
from repro_torch.models.recsys.fm import FMConfig

CONFIG = FMConfig(
    name="fm", n_sparse=39, vocab_per_field=1_000_000, embed_dim=10,
    interaction="fm-2way",
)

ARCH = ArchDef(
    name="fm", family="recsys", tag="recsys", config=CONFIG,
    shapes=recsys_shapes(),
    source="ICDM'10 (Rendle)",
    notes="EmbeddingBag = index_select + index_add_; retrieval = torch.mv",
)
