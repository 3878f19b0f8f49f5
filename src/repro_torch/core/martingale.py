"""Martingale sampling bounds from Tang, Shi, Xiao (SIGMOD'15), as used by
IMM Algorithm 1 (paper Alg. 1: Theta_Estimation / OPT_Lower_Bound / Set_Theta).

All quantities are host-side floats (they gate the Python-level sampling
loop); the heavy kernels run on the device elsewhere.
"""
from __future__ import annotations

import dataclasses
import math


def log_comb(n: int, k: int) -> float:
    """log(n choose k) via lgamma."""
    if k < 0 or k > n:
        return float("-inf")
    return (
        math.lgamma(n + 1) - math.lgamma(k + 1) - math.lgamma(n - k + 1)
    )


@dataclasses.dataclass(frozen=True)
class IMMBounds:
    n: int
    k: int
    eps: float
    ell: float           # adjusted ell' = ell * (1 + log 2 / log n)
    eps_prime: float     # sqrt(2) * eps
    lam_prime: float     # sampling-phase lambda'
    lam_star: float      # selection-phase lambda*
    max_rounds: int      # ceil(log2 n) - 1


def compute_bounds(n: int, k: int, eps: float, ell: float = 1.0) -> IMMBounds:
    n = max(int(n), 2)
    logn = math.log(n)
    # Tang'15 §4.2: replace ell by ell' so the union bound over the sampling
    # rounds still yields an overall 1 - 1/n^ell guarantee.
    ell_adj = ell * (1.0 + math.log(2.0) / logn)
    eps_p = math.sqrt(2.0) * eps
    logcnk = log_comb(n, k)
    loglog2n = math.log(max(math.log2(n), 1.0 + 1e-9))
    lam_prime = (
        (2.0 + 2.0 / 3.0 * eps_p)
        * (logcnk + ell_adj * logn + loglog2n)
        * n
        / (eps_p * eps_p)
    )
    alpha = math.sqrt(ell_adj * logn + math.log(2.0))
    beta = math.sqrt((1.0 - 1.0 / math.e) * (logcnk + ell_adj * logn + math.log(2.0)))
    lam_star = 2.0 * n * ((1.0 - 1.0 / math.e) * alpha + beta) ** 2 / (eps * eps)
    max_rounds = max(int(math.ceil(math.log2(n))) - 1, 1)
    return IMMBounds(
        n=n, k=k, eps=eps, ell=ell_adj, eps_prime=eps_p,
        lam_prime=lam_prime, lam_star=lam_star, max_rounds=max_rounds,
    )


def round_theta(bounds: IMMBounds, round_i: int) -> int:
    """theta_i = lambda' / x_i with x_i = n / 2^i (Alg. 1 sampling phase)."""
    x = bounds.n / (2.0 ** round_i)
    return int(math.ceil(bounds.lam_prime / x))


def round_target(bounds: IMMBounds, round_i: int) -> float:
    """Coverage target (1 + eps') * x_i that certifies the OPT lower bound."""
    x = bounds.n / (2.0 ** round_i)
    return (1.0 + bounds.eps_prime) * x


def lower_bound_from_coverage(bounds: IMMBounds, frac_covered: float) -> float:
    """OPT lower bound n*F(S)/(1+eps') once the round target is met."""
    return bounds.n * frac_covered / (1.0 + bounds.eps_prime)


def theta_from_lb(bounds: IMMBounds, lb: float) -> int:
    """Final theta = lambda* / LB (Alg. 1 Set_Theta)."""
    return int(math.ceil(bounds.lam_star / max(lb, 1.0)))
