"""g_roofline_pct: kernel G (``accumulate_kernel``, the accumulator's dense
round): its least time a call at the HBM bound, as the configuration's
frozen roofline counts it, over its mean device time a call in the traced
window, in %.  Nothing where G did not run or the roofline gives G no
bound."""

KERNEL = "accumulate_kernel"


def read(obs):
    least = obs.roofline.kernel_least_s(obs.cfg).get(KERNEL)
    if obs.device is None or least is None:
        return None
    durations = obs.device.kernel_durations(KERNEL)
    if not durations:
        return None
    return 100.0 * least / (sum(durations) / len(durations))
