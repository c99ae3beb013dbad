"""Seeded Poisson arrivals with diurnal bursts.

Counterpart of ``saturn_tpu/twin/arrivals.py``, draw for draw: the
generator consumes its RNG in one order, one ``expovariate`` gap and then
one ``randint`` priority per arrival, so a seed gives the JAX package's
trace.

Traffic shape: a Poisson base rate with periodic bursts. Every
``burst_every`` arrivals, a window of ``burst_len`` arrivals comes in at
``burst_rate_hz`` instead of ``base_rate_hz``, the pattern a service's
front door sees. Scaling both rates keeps the shape.
"""

from __future__ import annotations

import random
from dataclasses import dataclass
from typing import List, Mapping, Optional

#: The burst cycle: every 50 arrivals a burst window opens for 20 arrivals.
BURST_EVERY = 50
BURST_LEN = 20


@dataclass(frozen=True)
class Arrival:
    """One synthesized arrival on the stream's own time axis."""

    index: int
    at_s: float       # offset from the stream's start (cumulative gaps)
    gap_s: float      # the inter-arrival gap drawn for this arrival
    priority: float   # integer-valued priority class, 0.0 .. 2.0
    in_burst: bool    # whether the arrival fell inside a burst window
    tenant: Optional[str] = None  # its tenant (``tenant_mix`` runs only)


def arrival_stream(n_jobs: int, *,
                   base_rate_hz: float,
                   burst_rate_hz: float,
                   burst_every: int = BURST_EVERY,
                   burst_len: int = BURST_LEN,
                   seed: int = 0,
                   tenant_mix: Optional[Mapping[str, float]] = None,
                   ) -> List[Arrival]:
    """A deterministic arrival trace.

    The same ``(n_jobs, rates, cycle, seed)`` gives the same list wherever
    CPython's Mersenne Twister runs. Nonsensical rates raise.

    ``tenant_mix`` maps a tenant's name to a positive arrival weight: each
    arrival is tagged with a tenant drawn from the mix. Tenant draws come
    from a separate RNG stream seeded ``f"{seed}:tenant"``, so the gap and
    priority draws are untouched: adding tenants to a seed tags the same
    trace.
    """
    if n_jobs < 0:
        raise ValueError(f"n_jobs must be >= 0, got {n_jobs}")
    if base_rate_hz <= 0 or burst_rate_hz <= 0:
        raise ValueError(f"arrival rates must be positive, got base={base_rate_hz} "
                         f"burst={burst_rate_hz}")
    if burst_every <= 0 or burst_len < 0:
        raise ValueError(f"burst cycle must satisfy burst_every > 0 and burst_len >= 0, "
                         f"got every={burst_every} len={burst_len}")
    tenants = None
    weights = None
    tenant_rng = None
    if tenant_mix:
        if any(w <= 0 for w in tenant_mix.values()):
            raise ValueError(f"tenant_mix weights must be positive, got {tenant_mix}")
        tenants = list(tenant_mix)
        weights = [float(tenant_mix[t]) for t in tenants]
        tenant_rng = random.Random(f"{seed}:tenant")
    rng = random.Random(seed)
    out: List[Arrival] = []
    t = 0.0
    for i in range(n_jobs):
        in_burst = (i % burst_every) < burst_len
        rate = burst_rate_hz if in_burst else base_rate_hz
        gap = rng.expovariate(rate)
        priority = float(rng.randint(0, 2))
        tenant = (tenant_rng.choices(tenants, weights=weights)[0]
                  if tenant_rng is not None else None)
        t += gap
        out.append(Arrival(index=i, at_s=t, gap_s=gap, priority=priority,
                           in_burst=in_burst, tenant=tenant))
    return out
