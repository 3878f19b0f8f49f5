"""Real spherical-harmonic machinery for eSCN/Equiformer-v2
(``repro.models.gnn.irreps``).

`wigner_d_stack` builds the real Wigner rotation matrices D^l(R) for
l = 0..l_max from a batch of 3x3 rotations via the Ivanic-Ruedenberg
recursion (J. Phys. Chem. 1996, 100, 6342, with the 1998 erratum), the
algorithm e3nn uses for real spherical harmonics.  Everything is
vectorized over the edge batch and unrolled over (l, m, m') when it runs,
exactly as the reference unrolls it at trace time: the same terms, added
in the same order (sum_l (2l+1)^2 = 455 entries for l_max = 6).

Conventions: real SH order m = -l..l; the l=1 basis is (Y, Z, X) so that
D^1 is the permuted rotation matrix itself.

Properties tested: homomorphism D(R1 R2) = D(R1) D(R2), orthogonality,
and D^1 == permuted R.
"""
from __future__ import annotations

import math
from functools import lru_cache

import torch


def rotation_to_align_z(vec: torch.Tensor, eps: float = 1e-9):
    """Batch of rotations R with R @ v_hat = z_hat.

    Stable half-angle form R = I + K + K^2/(1+c) with K = skew(v x z): no
    division by sin(angle), so near-aligned edges stay well-conditioned
    (only v ~ -z needs a branch: a 180-degree flip about x).  Both
    branches are computed with denominators >= eps and one is picked, so
    a zero-length or a -z edge keeps a finite value and gradient.
    vec: (..., 3) -> (..., 3, 3).
    """
    v = vec / (torch.linalg.norm(vec, dim=-1, keepdim=True) + eps)
    c = v[..., 2]                                    # cos(angle) = v . z
    # w = v x z = (vy, -vx, 0)
    wx, wy = v[..., 1], -v[..., 0]
    zero = torch.zeros_like(wx)
    K = torch.stack([
        torch.stack([zero, zero, wy], -1),
        torch.stack([zero, zero, -wx], -1),
        torch.stack([-wy, wx, zero], -1),
    ], -2)
    eye = torch.eye(3, dtype=vec.dtype, device=vec.device)
    cc = c[..., None, None]
    K2 = K @ K
    # two branches, both with denominator >= 1:
    #   c >= 0: align v -> z directly
    #   c <  0: align v -> -z (w' = -w, c' = -c), then flip about x
    r_pos = eye + K + K2 / torch.clamp(1.0 + cc, min=eps)
    flip = torch.diag(torch.tensor([1.0, -1.0, -1.0], dtype=vec.dtype,
                                   device=vec.device))
    r_neg = flip @ (eye - K + K2 / torch.clamp(1.0 - cc, min=eps))
    return torch.where(cc >= 0, r_pos, r_neg)


def _perm_l1(R: torch.Tensor) -> torch.Tensor:
    """Real-SH l=1 rotation in (Y, Z, X) order from the 3x3 rotation:
    r[m, m'] = R[axis(m), axis(m')] with axis(-1)=1(y), axis(0)=2(z),
    axis(1)=0(x)."""
    axes = [1, 2, 0]
    return R[..., axes, :][..., :, axes]


@lru_cache(maxsize=None)
def _uvw(l: int, mu: int, mp: int):
    """Scalar u, v, w coefficients of the recursion (host-side)."""
    if abs(mp) < l:
        denom = (l + mp) * (l - mp)
    else:
        denom = (2 * l) * (2 * l - 1)
    u = math.sqrt((l + mu) * (l - mu) / denom)
    d0 = 1.0 if mu == 0 else 0.0
    v = 0.5 * math.sqrt((1 + d0) * (l + abs(mu) - 1) * (l + abs(mu)) / denom) \
        * (1 - 2 * d0)
    w = -0.5 * math.sqrt((l - abs(mu) - 1) * (l - abs(mu)) / denom) * (1 - d0)
    return u, v, w


def _wigner_next(l: int, r1: torch.Tensor, Rprev: torch.Tensor):
    """D^l from D^1 (r1, indexed m,m' in -1..1) and D^{l-1} (Rprev)."""
    # the (..., k) columns once, so each term below is one product
    r1c = r1.unbind(-1)
    r1e = [[c.select(-1, i) for c in r1c] for i in range(3)]
    pr = [row.unbind(-1) for row in Rprev.unbind(-2)]

    def r(i, j):
        return r1e[i + 1][j + 1]

    def prev(mu, mp):
        # Rprev has indices -(l-1)..(l-1)
        return pr[mu + l - 1][mp + l - 1]

    def P(i, mu, mp):
        if mp == l:
            return r(i, 1) * prev(mu, l - 1) - r(i, -1) * prev(mu, -l + 1)
        if mp == -l:
            return r(i, 1) * prev(mu, -l + 1) + r(i, -1) * prev(mu, l - 1)
        return r(i, 0) * prev(mu, mp)

    rows = []
    for mu in range(-l, l + 1):
        row = []
        for mp in range(-l, l + 1):
            u, v, w = _uvw(l, mu, mp)
            total = 0.0
            if u != 0.0:
                total = total + u * P(0, mu, mp)
            if v != 0.0:
                if mu == 0:
                    V = P(1, 1, mp) + P(-1, -1, mp)
                elif mu > 0:
                    d1 = 1.0 if mu == 1 else 0.0
                    V = P(1, mu - 1, mp) * math.sqrt(1 + d1) \
                        - P(-1, -mu + 1, mp) * (1 - d1)
                else:
                    dm1 = 1.0 if mu == -1 else 0.0
                    V = P(1, mu + 1, mp) * (1 - dm1) \
                        + P(-1, -mu - 1, mp) * math.sqrt(1 + dm1)
                total = total + v * V
            if w != 0.0:
                if mu > 0:
                    W = P(1, mu + 1, mp) + P(-1, -mu - 1, mp)
                elif mu < 0:
                    W = P(1, mu - 1, mp) - P(-1, -mu + 1, mp)
                else:
                    W = 0.0
                total = total + w * W
            if not isinstance(total, torch.Tensor):
                total = torch.full_like(r1e[0][0], total)
            row.append(total)
        rows.append(torch.stack(row, -1))
    return torch.stack(rows, -2)


def wigner_d_stack(R: torch.Tensor, l_max: int) -> list:
    """R: (..., 3, 3) -> list of (..., 2l+1, 2l+1) for l = 0..l_max."""
    batch = R.shape[:-2]
    mats = [torch.ones(batch + (1, 1), dtype=R.dtype, device=R.device)]
    if l_max >= 1:
        r1 = _perm_l1(R)
        mats.append(r1)
        prev = r1
        for l in range(2, l_max + 1):
            prev = _wigner_next(l, r1, prev)
            mats.append(prev)
    return mats


def sph_harm_from_wigner(vec: torch.Tensor, l_max: int) -> torch.Tensor:
    """Real SH of directions via the m=0 row of D(R_align):
    Y_l(v) = D^l(R)^T Y_l(z), and Y_l(z) is nonzero only at m=0 with value
    sqrt((2l+1)/(4 pi)).  Returns (..., (l_max+1)^2)."""
    R = rotation_to_align_z(vec)
    mats = wigner_d_stack(R, l_max)
    outs = []
    for l, D in enumerate(mats):
        norm = math.sqrt((2 * l + 1) / (4 * math.pi))
        outs.append(D[..., l, :] * norm)   # m=0 row (center index l)
    return torch.cat(outs, dim=-1)


def num_sph(l_max: int) -> int:
    return (l_max + 1) ** 2


def l_slices(l_max: int):
    """[(start, end, l)] index ranges of each l block in flattened order."""
    out, start = [], 0
    for l in range(l_max + 1):
        out.append((start, start + 2 * l + 1, l))
        start += 2 * l + 1
    return out
