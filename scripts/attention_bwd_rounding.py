#!/usr/bin/env python3
"""How far each bf16 rounding of a flash-attention backward puts the
gradient from the f32 one, on the host.

    PYTHONPATH=src python3 scripts/attention_bwd_rounding.py \
        [--shape B,Hq,Hkv,S,D ...] [--device cpu|cuda]

For bf16 q, k, v, dO drawn from a seed (by default the shapes of
``tests/test_torch_lm_train_cuda.py``'s gradient cases, and grok-1's GQA
48:8; ``--shape 4,16,16,4096,64 --device cuda`` is Qwen1.5-0.5B's
training shape, which takes ~30 GB), the backward's arithmetic in f32
with one choice at a time made as a tensor-core kernel would make it,
against autograd of the plain forward on f32 copies: P rounded to bf16
as the A operand of dV = P^T dO, dS rounded to bf16 as the A operand of
dQ and dK, and delta = rowsum(dO * O) in place of rowsum(P * dP), from an
output whose P.V rounded P to bf16 (as the forward kernel's does), kept
in f32 (a forward that wrote an f32 copy of O) or rounded to bf16 (the
output the forward returns); and the kernel's own combinations
(``design``, D <= 64: P as a bf16 part and its residue, dS rounded once,
delta from P, dQ summed in f32 over 128-key blocks in ascending order;
``design_above_64``: dK takes dS in two parts, dQ over 64-key tiles).
Each gradient is rounded to bf16 once, as the kernels round it.  Prints
one JSON line a shape and choice: the max of |err| / (1 + |ref|) for dq,
dk and dv, the measure the bf16 tolerance of 1e-2 bounds.  This is what
`csrc/flash_attention_bwd_tc.cu` chose its operands' roundings and its
delta from.
"""
from __future__ import annotations

import argparse
import json
import math

import torch

from repro_torch.kernels import flash_attention as fa

#: (B, Hq, Hkv, S, D)
SHAPES = ((1, 48, 8, 140, 128), (1, 8, 2, 300, 64), (2, 4, 4, 256, 64),
          (4, 16, 16, 512, 64))
#: (name, P as the A operand of dV = P^T dO: "f32", "bf16" (rounded once)
#: or "split" (a bf16 part and the bf16 rounding of what it left), dS
#: rounded to bf16 (True) or only for dQ ("dq"; dK takes two parts),
#: delta from: "p" rowsum(P * dP), "f32_output" or "bf16_output"
#: rowsum(dO * O) with O = bf16(P) V, and dQ summed over key blocks of
#: this many keys in ascending order (0: in one product)); "design" is
#: csrc/flash_attention_bwd_tc.cu's at D <= 64, "design_above_64" above
CHOICES = (("none", "f32", False, "p", 0), ("p", "bf16", False, "p", 0),
           ("ds", "f32", True, "p", 0),
           ("delta_from_f32_output", "f32", False, "f32_output", 0),
           ("delta_from_bf16_output", "f32", False, "bf16_output", 0),
           ("all", "bf16", True, "bf16_output", 0),
           ("design", "split", True, "p", 128),
           ("design_above_64", "split", "dq", "p", 64))


def emulated(q, k, v, dout, p_as: str, round_ds, delta_from: str,
             dq_block: int = 0):
    B, Hq, S, D = q.shape
    group = Hq // k.shape[1]
    q, k, v, dout = (t.float() for t in (q, k, v, dout))
    kk, vv = (t.repeat_interleave(group, dim=1) for t in (k, v))
    s = torch.einsum("bhqd,bhkd->bhqk", q, kk) / math.sqrt(D)
    pos = torch.arange(S, device=q.device)
    s = s.masked_fill(pos[None, :] > pos[:, None], float("-inf"))
    p = torch.exp(s - torch.logsumexp(s, dim=-1, keepdim=True))
    del s
    p16 = p.bfloat16().float()
    dp = torch.einsum("bhqd,bhkd->bhqk", dout, vv)
    if delta_from == "p":
        delta = (p * dp).sum(-1)
    else:
        o = torch.einsum("bhqk,bhkd->bhqd", p16, vv)
        if delta_from == "bf16_output":
            o = o.bfloat16().float()
        delta = (dout * o).sum(-1)
    ds = p * (dp - delta[..., None])
    del dp
    ds_k = ds
    if round_ds:
        ds = ds.bfloat16().float()
        if round_ds != "dq":
            ds_k = ds
    if dq_block:
        dq = torch.zeros_like(q)
        for k0 in range(0, S, dq_block):
            dq += torch.einsum("bhqk,bhkd->bhqd", ds[..., k0:k0 + dq_block],
                               kk[:, :, k0:k0 + dq_block])
        dq = dq / math.sqrt(D)
    else:
        dq = torch.einsum("bhqk,bhkd->bhqd", ds, kk) / math.sqrt(D)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds_k, q) / math.sqrt(D)
    if p_as == "split":
        dv = torch.einsum("bhqk,bhqd->bhkd", p16, dout) + torch.einsum(
            "bhqk,bhqd->bhkd", (p - p16).bfloat16().float(), dout)
    else:
        dv = torch.einsum("bhqk,bhqd->bhkd", p16 if p_as == "bf16" else p,
                          dout)
    dk = dk.view(B, -1, group, S, D).sum(2)
    dv = dv.view(B, -1, group, S, D).sum(2)
    return [g.bfloat16().float() for g in (dq, dk, dv)]


def reference(q, k, v, dout):
    """dq, dk, dv by autograd of the plain forward on f32 copies."""
    ref = [t.float().requires_grad_() for t in (q, k, v)]
    return torch.autograd.grad(fa.flash_attention_plain(*ref), ref,
                               dout.float())


def errors(got, want) -> dict:
    """max |err| / (1 + |ref|) of dq, dk and dv."""
    return {g: float(((a - w).abs() / (1 + w.abs())).max())
            for g, a, w in zip(("dq", "dk", "dv"), got, want)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shape", action="append", default=None,
                    help="B,Hq,Hkv,S,D (repeatable); default: SHAPES")
    ap.add_argument("--device", default="cpu")
    args = ap.parse_args()
    shapes = SHAPES if args.shape is None else [
        tuple(int(x) for x in a.split(",")) for a in args.shape]
    for B, Hq, Hkv, S, D in shapes:
        gen = torch.Generator().manual_seed(S + D)

        def draw(h):
            return torch.randn((B, h, S, D), generator=gen).bfloat16().to(
                args.device)

        q, k, v, dout = draw(Hq), draw(Hkv), draw(Hkv), draw(Hq)
        want = reference(q, k, v, dout)
        for name, *choice in CHOICES:
            err = errors(emulated(q, k, v, dout, *choice), want)
            print(json.dumps({"shape": [B, Hq, Hkv, S, D], "rounded": name,
                              **err}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
