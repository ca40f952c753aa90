"""job_teardown_ms: each job's tear-down on the thread that calls ``fit``
(the ``job.teardown`` spans of ``Session(trace=True)``, category ``job``:
the copies of the results back to the host), added over the window and
divided by its iterations, in ms.  Nothing where the program records no
such span."""


def read(obs):
    teardowns = [d for cat, name, d in obs.spans
                 if cat == "job" and name == "job.teardown"]
    if not teardowns or not obs.iters:
        return None
    return sum(teardowns) / obs.iters * 1e3
