"""Models of the port: the LM family (``transformer``, ``moe``, ``layers``),
the GNN family (``mace``) and the recsys family (``recsys``)."""
