"""Shared shed-retry backoff schedule (overload plane).

One schedule, three users — the owner's deferred-spec retry
(``node_manager._defer_shed``), the in-worker nested client's
``_backpressured_call``, and anything else honoring a
``SystemOverloadError.backoff_s`` hint — so a change to the policy
(full jitter, different hint precedence) lands once, not per-site.
"""

from __future__ import annotations

import random


def make_rng() -> random.Random:
    """The plane's jitter RNG: seeded from chaos_seed when it is
    NONZERO (0, the default, means unseeded) so tests reproduce the
    exact retry cadence; per-process entropy otherwise, so concurrent
    shed victims don't retry in lock-step — the herd the jitter
    exists to break up."""
    from ray_tpu_torch._private.config import get_config
    return random.Random(get_config().chaos_seed or None)


def next_backoff(prev_s: float, base_s: float, cap_s: float,
                 hint_s: float = 0.0) -> float:
    """The next shed-retry delay: exponential from ``base_s``
    (doubling ``prev_s``), a server-suggested ``hint_s`` winning when
    larger, everything clamped to ``cap_s``."""
    return min(cap_s, max(base_s, prev_s * 2.0, hint_s))


def jittered(delay_s: float, rng) -> float:
    """Half-jitter: uniform in [0.5x, 1x] of ``delay_s`` — concurrent
    shed victims spread out instead of re-submitting in lock-step."""
    return delay_s * (0.5 + 0.5 * rng.random())
