"""EmptyHeaded core (port): datalog -> GHD plan -> Generic-Join execution."""
from repro_torch.core.engine import Engine, QueryResult  # noqa: F401
from repro_torch.core.trie import CSRGraph, Trie  # noqa: F401
