"""Greedy max-coverage directly over encoded arenas
(``repro.core.pack.selection`` and the packed/compressed branches of
``repro.core.selection.select_fused``).

Every round's counter comes from a decode-and-count kernel —
``packed_count`` for bit-packed rows, ``token_count`` for token rows —
and the winner's rows from the codec's one-column ``decode_cols``, so
the decoded ``(theta, n)`` arena never exists.  (The reference's
``select_packed`` unpacks the whole arena inside jit; eager PyTorch would
hold that as a temporary, 5.49 GB at the com-Amazon cell.)  Counts are
exact int32 and ``torch.argmax`` keeps ``jnp.argmax``'s first maximum, so
every method picks the seeds of ``select_dense`` over the decoded rows.
The fused and unfused methods run the same rounds here: on an encoded
arena both reduce through the decode-and-count kernels.

Registered layouts: ``{rebuild,decrement}-{packed,compressed}`` and
``fused-{rebuild,decrement}-{packed,compressed}``.
"""
from __future__ import annotations

import torch

from repro_torch.core.selection import greedy, register_selection
from repro_torch.kernels import ops as kops


def select_codec(R, valid, n: int, k: int, method: str = "rebuild", *,
                 codec):
    """R: ``(theta, codec.width)`` encoded rows (packed bytes or
    tokens); valid: (theta,) bool.  Returns (seeds (k,) int32,
    covered_frac () f32, gains (k,) int32)."""
    if codec.kind == "packed":
        def count(mask):
            return kops.packed_count(R, mask, n=n)
    elif codec.kind == "compressed":
        def count(mask):
            return kops.token_count(R, mask, n=n)
    else:
        raise ValueError(f"select_codec needs a packed or compressed codec, "
                         f"got {codec.kind!r}")

    def pick(alive, counter):
        return torch.argmax(count(alive) if counter is None else counter)

    def member(v):
        return codec.decode_cols(R, v.view(1))[:, 0]

    return greedy(valid, k, method, pick, count, member)


def _codec_strategy(method):
    def run(view, k, *, codec, **_):
        return select_codec(view.R, view.valid, view.n, k, method,
                            codec=codec)
    return run


for _m in ("rebuild", "decrement"):
    for _layout in ("packed", "compressed"):
        register_selection(f"{_m}-{_layout}", _codec_strategy(_m))
        register_selection(f"fused-{_m}-{_layout}", _codec_strategy(_m))
