"""The reading shared by the per-kernel roofline shares: a kernel's least
time a call at the HBM bound, as the configuration's frozen roofline counts
it (``kernel_least_s``, by kernel name), over its mean device time a call
in the traced window, in %.  Nothing where the kernel did not run or the
roofline gives it no bound."""


def read_kernel(obs, kernel: str):
    least = obs.roofline.kernel_least_s(obs.cfg).get(kernel)
    if obs.device is None or least is None:
        return None
    durations = obs.device.kernel_durations(kernel)
    if not durations:
        return None
    return 100.0 * least / (sum(durations) / len(durations))
