"""sync_wait_ms: the host's reads of device values on the round path (the
``device-sync`` spans of ``Session(trace=True)``, such as the AUTO rule's
``accumulate.decide``, each waiting for every kernel queued before it),
added over the window and divided by its iterations, in ms.  Nothing where
the program records no such span."""


def read(obs):
    syncs = [d for cat, _, d in obs.spans if cat == "device-sync"]
    if not syncs or not obs.iters:
        return None
    return sum(syncs) / obs.iters * 1e3
