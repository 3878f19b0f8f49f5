"""Every module of the JAX package has a port: a file of
``src/repro_torch/`` at the same relative path, or an entry in
`NO_COUNTERPART` with the reason there is none.  A reference module that
is neither ported nor listed fails, and so does a listed one that gained
a port."""
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF = os.path.join(ROOT, "src", "repro")
PORT = os.path.join(ROOT, "src", "repro_torch")

#: reference modules with no port file, each with its reason
NO_COUNTERPART = {
    "compat.py": "shims jax.shard_map's move between jax versions; the "
                 "port's collectives take every tile at once "
                 "(repro_torch/mesh.py psum_over), so a meshed function "
                 "is written over tiles and needs no shim",
    "kernels/_pad.py": "Pallas reads undefined values past a block's end; "
                       "the port's CUDA kernels bound-check their tails "
                       "(kernels/_common.py padded_width for row strides)",
    "launch/hlo_analysis.py": "parses XLA's optimized HLO text; PyTorch "
                              "eager lowers nothing, and the collective "
                              "census of repro_torch/mesh.py "
                              "(launch/dryrun.py collective_census) "
                              "replaces its counts",
}


def _modules(root):
    out = set()
    for d, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                out.add(os.path.relpath(os.path.join(d, f), root))
    return out


def test_every_reference_module_has_a_port_or_a_reason():
    ref, port = _modules(REF), _modules(PORT)
    missing = sorted(ref - port - set(NO_COUNTERPART))
    assert missing == [], f"reference modules with no port: {missing}"


@pytest.mark.parametrize("path", sorted(NO_COUNTERPART))
def test_a_listed_module_is_in_the_reference_and_has_no_port(path):
    assert os.path.isfile(os.path.join(REF, path))
    assert not os.path.exists(os.path.join(PORT, path))
    assert NO_COUNTERPART[path]
