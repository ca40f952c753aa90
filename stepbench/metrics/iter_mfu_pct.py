"""iter_mfu_pct: the least time of an iteration on the chip, as the
configuration's frozen roofline counts it (``roofline/<config>.py``), over
the traced run's time per iteration, in %."""


def read(obs):
    if not obs.iters:
        return None
    return 100.0 * obs.roofline.iteration_least_s(obs.cfg) / (obs.window_s / obs.iters)
