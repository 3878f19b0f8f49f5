"""Models of the port (``repro.models``): the decoder-only LM
(``transformer``, dense or MoE: ``moe``, and ``moe_sharded`` on a
`repro_torch.mesh.Mesh`), trained and served, and the FM recsys model
(``recsys.fm``), served and trained.  The GNNs wait for their slice
(ROADMAP A9c)."""
