"""Models of the port (``repro.models``): the dense decoder-only LM that
the LM server runs.  MoE, the GNNs and the recsys models wait for their
slices (ROADMAP A9)."""
