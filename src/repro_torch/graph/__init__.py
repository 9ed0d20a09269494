"""Graph preprocessing: dictionary encoding, node orderings, symmetric
pruning and skew statistics (paper Section 2.2 and Appendix C.2;
counterpart of ``repro.graph``, host numpy like the reference)."""
from repro_torch.graph.dictionary import Dictionary, encode_edges  # noqa: F401
from repro_torch.graph.ordering import (ORDERINGS, apply_ordering,  # noqa: F401
                                        order_nodes)
from repro_torch.graph.prune import prune_symmetric, symmetrize  # noqa: F401
from repro_torch.graph.stats import density_skew, graph_stats  # noqa: F401
