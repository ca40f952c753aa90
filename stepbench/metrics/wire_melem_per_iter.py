"""wire_melem_per_iter: the accumulator's wire traffic
(``Session.wire_traffic()``, vector elements, exact) over the window's
iterations, in millions of elements."""


def read(obs):
    return obs.wire_elements / obs.iters / 1e6 if obs.iters else None
