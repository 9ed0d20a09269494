from repro_torch.data.graphs import edge_list, powerlaw_graph  # noqa: F401
