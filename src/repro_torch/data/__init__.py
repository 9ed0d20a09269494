"""Data generators of the port: the synthetic power-law and Kronecker
graphs of ``repro.data.graphs`` and the recsys batches of
``repro.data.recsys``, copied (numpy only) so the port needs nothing of
``repro``."""
from repro_torch.data.graphs import (edge_list, kronecker_graph,  # noqa: F401
                                     powerlaw_graph)
from repro_torch.data.recsys import RecsysBatchGen  # noqa: F401
