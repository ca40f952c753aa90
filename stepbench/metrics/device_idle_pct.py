"""device_idle_pct: the share of the traced window in which no operation
ran on the device (``torch.profiler``: the union of the device
operations' intervals over the window's length), in %."""


def read(obs):
    dev = obs.device
    if dev is None or dev.busy_s <= 0 or dev.window_s <= 0:
        return None
    return 100.0 * (1.0 - dev.busy_s / dev.window_s)
