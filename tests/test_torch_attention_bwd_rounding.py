"""The bf16 attention backward's precision choice, on the host.

``csrc/flash_attention_bwd_tc.cu`` feeds its tensor-core products bf16
operands: P enters dV = P^T dO as a bf16 part and the bf16 rounding of
what that part left (exact to 2**-16), dS is rounded once to bf16 for dQ
and, at D <= 64, for dK (above it dK takes dS in two parts too), delta
is rowsum(P * dP) of the f32 P, dQ is summed in f32 over key blocks in
ascending order (128 keys at D <= 64, 64-key tiles above), and each
gradient is rounded to bf16 once.  ``scripts/attention_bwd_rounding.py``
emulates both combinations (its ``design`` and ``design_above_64``
rows) in f32; here each is held against autograd of
``flash_attention_plain`` on f32 copies within the bf16 bound that the
card tests use (``ATTN_TOL``: 1e-2 (1 + |ref|)), at the script's four
shapes, inputs drawn with numpy from seed 0.  A last case shows why P
keeps its residue: P rounded once puts dV past the bound at grok-1's GQA
48:8 (at this draw; over seeds 0-5 it lands between 0.0097 and 0.0153).
"""
import importlib.util
import os

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATTN_TOL = 1e-2


def _script():
    spec = importlib.util.spec_from_file_location(
        "attention_bwd_rounding",
        os.path.join(ROOT, "scripts", "attention_bwd_rounding.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


rounding = _script()
ROWS = dict((name, choice) for name, *choice in rounding.CHOICES)
DESIGN = ROWS["design"]


def _design(D):
    """The kernel's combination at head dim D."""
    return DESIGN if D <= 64 else ROWS["design_above_64"]


def _inputs(B, Hq, Hkv, S, D, seed=0):
    rng = np.random.default_rng(seed)

    def draw(h):
        return torch.from_numpy(rng.standard_normal(
            (B, h, S, D), dtype=np.float32)).bfloat16()

    return draw(Hq), draw(Hkv), draw(Hkv), draw(Hq)


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def test_design_rows_are_the_kernels_combinations():
    assert DESIGN == ["split", True, "p", 128]
    assert ROWS["design_above_64"] == ["split", "dq", "p", 64]


@pytest.mark.parametrize("B,Hq,Hkv,S,D", rounding.SHAPES)
def test_design_rounding_within_the_bf16_bound(B, Hq, Hkv, S, D):
    q, k, v, dout = _inputs(B, Hq, Hkv, S, D)
    want = rounding.reference(q, k, v, dout)
    err = rounding.errors(rounding.emulated(q, k, v, dout, *_design(D)),
                          want)
    assert max(err.values()) <= ATTN_TOL, err


def test_p_in_two_parts_is_exact_to_2_pow_16():
    """The hi part and the rounding of its residue sum to P within
    2**-16 of it, so dV's products see P nearly as f32."""
    p = torch.from_numpy(np.random.default_rng(1).random(
        (64, 4096), dtype=np.float32))
    hi = p.bfloat16().float()
    lo = (p - hi).bfloat16().float()
    assert bool(((hi + lo - p).abs() <= p.abs() * 2.0 ** -16).all())


def test_ordered_dq_blocks_agree_with_one_product():
    """dQ summed over 64-key blocks in ascending order (a D 256 block's
    keys) is dQ in one product up to f32 rounding, before the last bf16
    rounding."""
    q, k, v, dout = _inputs(1, 8, 2, 300, 64, seed=2)
    split, ds, delta, _ = DESIGN
    blocks = rounding.emulated(q, k, v, dout, split, ds, delta, 64)
    whole = rounding.emulated(q, k, v, dout, split, ds, delta, 0)
    for a, b in zip(blocks, whole):
        assert bool(((a - b).abs() <= 2.0 ** -7 * (1 + b.abs())).all())


def test_p_rounded_once_breaks_the_bound_at_gqa_48_8():
    """Why P keeps its residue: rounded once (FA2's and FA3's choice) it
    puts dV past the bound at grok-1's heads, where the design's split
    stays inside it."""
    q, k, v, dout = _inputs(1, 48, 8, 140, 128)
    want = rounding.reference(q, k, v, dout)
    once = rounding.errors(rounding.emulated(q, k, v, dout, "bf16", False,
                                             "p", 0), want)
    split = rounding.errors(rounding.emulated(q, k, v, dout,
                                              *_design(128)), want)
    assert once["dv"] > ATTN_TOL
    assert split["dv"] <= ATTN_TOL / 2
