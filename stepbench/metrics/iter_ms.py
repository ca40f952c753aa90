"""iter_ms: the window's jobs' walls, added, over the iterations of its
complete jobs (host clock; each job ended by a synchronise), in ms."""


def read(obs):
    return obs.window_s / obs.iters * 1e3 if obs.iters else None
