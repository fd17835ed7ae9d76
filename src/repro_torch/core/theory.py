"""Parameter-selection math from the paper (host-side floats).

A copy of the part of the reference's ``core/theory.py`` that the port
needs: the p-stable collision probability that ``SANNConfig.resolved``
turns into ``k`` and ``L``."""
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
