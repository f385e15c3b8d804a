"""Models of the port: the recsys family (``recsys``) and ``layers.dense_init``;
the LM and GNN families wait for ROADMAP A8."""
