"""Models of the port: the LM family (``transformer``, ``moe``, ``layers``)
and the recsys family (``recsys``); the GNN family waits for ROADMAP A,
item 2."""
