"""barrier_wait_ms: the time the session's threads spent parked on
barriers (the ``barrier-wait`` spans of ``Session(trace=True)``), per
thread and iteration, in ms."""


def read(obs):
    waits = [d for cat, _, d in obs.spans if cat == "barrier-wait"]
    if not waits or not obs.iters or not obs.n_threads:
        return None
    return sum(waits) / (obs.n_threads * obs.iters) * 1e3
