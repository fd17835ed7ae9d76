"""Parameter selection and guarantee formulas from the paper (host-side
floats): a copy of the reference's ``core/theory.py``, used by config
builders (``SANNConfig.resolved``) and by checks against the paper's own
claims."""
from __future__ import annotations

import math


def pstable_p(dist: float, w: float) -> float:
    """Collision probability of one p-stable (2-stable) hash at distance
    ``dist`` with bucket width ``w`` [DIIM04]."""
    if dist <= 0:
        return 1.0
    t = w / dist
    phi = 0.5 * (1.0 + math.erf(-t / math.sqrt(2.0)))
    return max(
        0.0,
        min(1.0, 1.0 - 2.0 * phi - (2.0 / (math.sqrt(2.0 * math.pi) * t))
            * (1.0 - math.exp(-(t * t) / 2.0))),
    )


def srp_p(angle: float) -> float:
    """Collision probability of one SRP bit at angle ``angle`` [Cha02]."""
    return 1.0 - angle / math.pi


def rho(p1: float, p2: float) -> float:
    """LSH quality exponent rho = log(1/p1)/log(1/p2) (Thm 2.2)."""
    return math.log(1.0 / p1) / math.log(1.0 / p2)


def choose_k(n: int, p2: float) -> int:
    """Lemma 3.2: k = ceil(log_{1/p2} n) kills far collisions to 1/n."""
    return max(1, math.ceil(math.log(n) / math.log(1.0 / p2)))


def choose_L(n: int, p1: float, p2: float) -> int:
    """Lemma 3.3: L = n^rho / p1 gives constant per-table recall."""
    return max(1, math.ceil(n ** rho(p1, p2) / p1))


def sann_space_words(n: int, eta: float, p1: float, p2: float) -> float:
    """Theorem 3.1 space bound O(n^{1+rho-eta} / p1) in words."""
    return n ** (1.0 + rho(p1, p2) - eta) / p1


def sann_failure_prob(n: int, eta: float, m: float) -> float:
    """Theorem 3.1 failure bound: 1/(3 n^eta) + (e^{mp} + e - 1)/e^{mp+1},
    with p = n^-eta the sampling rate and m the Poisson ball mean."""
    p = n ** (-eta)
    mp = m * p
    return 1.0 / (3.0 * n**eta) + (math.exp(mp) + math.e - 1.0) / math.exp(mp + 1.0)


def turnstile_failure_prob(n: int, eta: float, m: float, d: int) -> float:
    """Theorem 3.3 failure bound with <= d deletions per r-ball."""
    p = n ** (-eta)
    mp = m * p
    if d <= 0:
        tail = math.exp(-mp)
    elif d > mp:        # the bound holds only for d <= lambda: clamp
        tail = 1.0
    else:
        tail = math.exp(d - mp + d * math.log(mp / d))
    return 1.0 / (3.0 * n**eta) + 1.0 / math.e + tail * (1.0 - 1.0 / math.e)


def poisson_tail_le(d: int, lam: float) -> float:
    """Lemma 3.4: P(S <= d) <= exp(d - lam + d ln(lam/d)) for d <= lam."""
    if d == 0:
        return math.exp(-lam)
    return math.exp(d - lam + d * math.log(lam / d))


def swakde_rows(max_x: float, K: float, eps: float, delta: float) -> int:
    """Theorem 4.1: R = O(2 max{X_i}^2 / ((1+eps) K^2) * log(2/delta))."""
    return max(1, math.ceil(2.0 * max_x**2 / ((1.0 + eps) * K**2)
                            * math.log(2.0 / delta)))


def eh_eps_for_kde_eps(eps: float) -> float:
    """Lemma 4.4 inversion: eps = 2 eps' + eps'^2  =>  eps' = sqrt(1+eps) - 1."""
    return math.sqrt(1.0 + eps) - 1.0


def swakde_space_bound(R: int, W: int, eps: float, N: int) -> float:
    """Lemma 4.4: O(R W (1/(sqrt(1+eps)-1)) log^2 N), in units of EH
    buckets × bits."""
    return R * W * (1.0 / eh_eps_for_kde_eps(eps)) * math.log2(max(N, 2)) ** 2
