from repro_torch.graph.prune import symmetrize  # noqa: F401
