"""Fault-tolerance drill (paper §5.4 + Fig. 11) on the PyTorch port.

Runs distributed K-means sessions (the ``kmeans_assign`` kernel on the card),
kills a node through the heartbeat monitor, and recovers twice — single-node
vs multi-node recovery — through ``ft.session_recovery``, which replans the
thread placement over the survivors and rolls a fresh Session onto the
surviving DSM.  With a sharded store (``shards=n_nodes``) recovery also
removes the dead node's shard from the consistent-hash ring: only its names
move to survivors, epochs intact.  Then checkpoint/rollback exactness for
the shared state.

    PYTHONPATH=src python examples/torch_fault_tolerance_drill.py                # the card
    PYTHONPATH=src python examples/torch_fault_tolerance_drill.py --device cpu
"""

import argparse
import tempfile
import time

import torch

from repro_torch.analytics import kmeans
from repro_torch.core import Session
from repro_torch.data import kmeans_dataset
from repro_torch.ft import HeartbeatMonitor, metrics_payload, restore_checkpoint, \
    save_checkpoint, session_recovery


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="where the sessions run (default: the card)")
    args = parser.parse_args(argv)
    x, _, _ = kmeans_dataset(4000, 16, 8, seed=0)
    n_nodes, tpn = 4, 2

    # -- failure detection ---------------------------------------------------
    # the session first: the monitor's clock starts when it is built, and
    # bringing up the card can outlast its 0.2 s timeout
    probe = Session(backend="host", n_nodes=n_nodes, threads_per_node=tpn,
                    device=args.device)
    failures = []
    mon = HeartbeatMonitor(list(range(n_nodes)), timeout=0.2,
                           on_failure=lambda dead: failures.append(dead))
    mon.start()
    for node in range(n_nodes):
        mon.beat(node, metrics_payload(probe))
    mon.declare_dead(2)   # drill: node 2 dies
    time.sleep(0.1)
    mon.stop()
    print(f"heartbeat detected failures: {failures}")

    # -- recovery planning: single vs multi (Fig. 11) --------------------------
    for mode in ("single", "multi"):
        failed_session = Session(backend="host", n_nodes=n_nodes, threads_per_node=tpn,
                                 shards=n_nodes, device=args.device)
        kmeans.fit(x, 8, iters=1, seed=0, use_kernel=True, session=failed_session)
        plan, recovered = session_recovery(
            failed_session, failures[0] if failures else [2], mode=mode,
            threads_per_node=tpn if mode == "multi" else tpn * 2)
        t0 = time.perf_counter()
        # recovery = reload the dead node's partitions + recompute one iteration
        kmeans.fit(x, 8, iters=1, seed=0, use_kernel=True, session=recovered)
        dt = (time.perf_counter() - t0) * 1e3
        mig = plan.migration
        moved = (f"ring: moved {len(mig.moved)}/{mig.total_names} keys off "
                 f"shard {mig.removed}" if mig else "ring: unchanged")
        print(f"{mode:>6s}-node recovery: reassign {plan.reassignment} "
              f"redo-iteration {dt:.0f}ms  {moved}")

    # -- checkpoint/rollback exactness ------------------------------------------
    with tempfile.TemporaryDirectory() as d:
        centers1, sess = kmeans.fit(x, 8, n_nodes=2, threads_per_node=2, iters=6, seed=0,
                                    use_kernel=True, device=args.device)
        state = {"centers": torch.from_numpy(centers1).to(sess.device)}
        save_checkpoint(d, 6, state)
        restored, _, step = restore_checkpoint(d, state, device=sess.device)
        exact = bool(torch.equal(restored["centers"], state["centers"]))
        assert exact
        print(f"checkpoint at iter {step} restores bit-exact: {exact}")


if __name__ == "__main__":
    main()
