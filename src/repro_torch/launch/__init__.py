"""Command-line entry points and the launchers (``repro.launch``).

`steps` builds every (arch x shape) cell and the IMM production cells on
a `repro_torch.mesh.Mesh` (`mesh` makes the production meshes,
`shardings` holds the policies); `dryrun` builds them all without
allocating and runs one on the card.

Three reference modules have no counterpart here:

* ``hlo_analysis.py`` and the roofline's ``parse_collectives`` and
  ``_shape_bytes`` read XLA's optimized HLO text (trip-count-corrected
  flops, fusion-boundary bytes, the collective census).  PyTorch eager
  lowers nothing; `dryrun.execute_cell` counts the executed flops with
  ``FlopCounterMode`` and reads the collective census every collective
  of `repro_torch.mesh` keeps (`dryrun.collective_census`).
* ``compat.py`` shims ``jax.shard_map``'s move between jax versions.  The
  port's collectives take every tile at once (`repro_torch.mesh.
  psum_over`), so a meshed function is written over tiles and needs no
  shim.
* ``kernels/_pad.py`` pads operands to Pallas block multiples, because
  Pallas reads undefined values past a block's end.  The port's CUDA
  kernels bound-check their tails (`repro_torch.kernels._common.
  padded_width` for row strides).
"""
