"""job_setup_ms: each job's set-up on the thread that calls ``fit`` (the
``job.setup`` spans of ``Session(trace=True)``, category ``job``: the app's
own set-up, its host draws and ``Session.spawn``), added over the window
and divided by its iterations, in ms.  Nothing where the program records
no such span."""


def read(obs):
    setups = [d for cat, name, d in obs.spans if cat == "job" and name == "job.setup"]
    if not setups or not obs.iters:
        return None
    return sum(setups) / obs.iters * 1e3
