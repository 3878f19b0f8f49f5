"""Models of the port (``repro.models``): the decoder-only LM
(``transformer``, dense or MoE: ``moe``, and ``moe_sharded`` on a
`repro_torch.mesh.Mesh`), trained and served, the FM recsys model
(``recsys.fm``), served and trained, and the GNNs (``gnn``: GraphSAGE,
GraphCast, EGNN and Equiformer-v2), trained."""
