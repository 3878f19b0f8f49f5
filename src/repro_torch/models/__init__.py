"""Models of the port (``repro.models``): the dense decoder-only LM that
the LM server runs (``transformer``) and the FM recsys model
(``recsys.fm``), served and trained.  MoE and the GNNs wait for their
slices (ROADMAP A9)."""
