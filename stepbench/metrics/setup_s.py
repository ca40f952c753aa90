"""setup_s: from the start of the run's process to the window's start:
imports, the device's context, the inputs made from the seed, the build of
any kernel not built yet, and one whole warm-up job (host clock), in s."""


def read(obs):
    return obs.setup_s
