"""round_p95_ms: the 95th percentile (nearest rank) of the app's rounds,
the ``app-round`` spans of every thread in the traced window, in ms."""

import math


def read(obs):
    rounds = sorted(d for cat, _, d in obs.spans if cat == "app-round")
    if not rounds:
        return None
    return rounds[math.ceil(0.95 * len(rounds)) - 1] * 1e3
