"""The port's step.ft (``repro_torch.ft``) against repro's.

Mirrors ``tests/test_checkpoint.py`` and ``tests/test_heartbeat.py`` case by
case, then holds the port to repro on the same numpy inputs: checkpoints
cross between the two packages bit for bit in both directions, with equal
manifests (leaf files, paths in JAX's sorted order, shapes, dtypes); a bf16
leaf round-trips in the port and its ``.npy`` file has repro's bytes;
``session_recovery`` on a small kmeans session gives repro's plan (equal
``reassignment`` and ``moved``) and centers within kmeans' 1e-4 / 1e-5; the
tree utilities flatten as JAX does; ``elastic_restore`` onto the port's
mesh checks its specs.  The FT drill example runs at its small size.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

import repro.ft as jft  # noqa: E402
import repro.utils.tree as jtree  # noqa: E402
from repro.core import Session as JSession  # noqa: E402
from repro_torch.core import Session, make_mesh  # noqa: E402
from repro_torch.core.compat import P  # noqa: E402
from repro_torch.ft import (  # noqa: E402
    PAYLOAD_KEYS, REBALANCE_KEYS, AsyncCheckpointer, Checkpoint, HeartbeatMonitor,
    elastic_restore, latest_step, list_checkpoints, metrics_payload, plan_recovery,
    rebalance_batch, reshard_tree, restore_checkpoint, save_checkpoint, session_recovery)
from repro_torch.utils import tree as ttree  # noqa: E402

CPU = "cpu"
ROOT = os.path.join(os.path.dirname(__file__), "..")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs files in parallel workers, and
    torch's default of one thread per core would oversubscribe the CPU
    under the timing-sensitive tests of other files."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tree():
    return {"a": torch.arange(6.0).reshape(2, 3), "b": {"c": torch.ones(4, dtype=torch.int32)}}


def _nested(rng):
    """One tree, as numpy, with keys out of sorted order, a list and a
    scalar: the order and paths of its leaves are JAX's sorted ones."""
    return {"z": rng.normal(size=(3, 4)).astype(np.float32),
            "a": [rng.normal(size=5).astype(np.float32),
                  rng.integers(-5, 5, size=(2, 2)).astype(np.int32)],
            "m": {"y": np.float32(rng.normal()), "b": rng.normal(size=(7,)).astype(np.float32)}}


def _as(tree_np, fn):
    if isinstance(tree_np, dict):
        return {k: _as(v, fn) for k, v in tree_np.items()}
    if isinstance(tree_np, list):
        return [_as(v, fn) for v in tree_np]
    return fn(tree_np)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _manifest(d, step):
    with open(os.path.join(d, f"step_{step:08d}", "manifest.json")) as f:
        m = json.load(f)
    return [{k: rec[k] for k in ("path", "file", "shape", "dtype")} for rec in m["leaves"]]


def _leaf_bytes(d, step):
    folder = os.path.join(d, f"step_{step:08d}")
    return {f: open(os.path.join(folder, f), "rb").read()
            for f in sorted(os.listdir(folder)) if f.endswith(".npy")}


# -- test_checkpoint.py's cases ------------------------------------------------


def test_roundtrip_and_latest(tmp_path):
    d = str(tmp_path)
    save_checkpoint(d, 3, tree(), extra={"k": 1})
    save_checkpoint(d, 9, tree())
    got, extra, step = restore_checkpoint(d, tree(), device=CPU)
    assert step == 9
    assert torch.equal(got["a"], tree()["a"]) and torch.equal(got["b"]["c"], tree()["b"]["c"])
    assert got["b"]["c"].dtype == torch.int32 and got["a"].device.type == "cpu"
    _, extra3, _ = restore_checkpoint(d, tree(), step=3, device=CPU)
    assert extra3 == {"k": 1}


def test_prune_keep(tmp_path):
    d = str(tmp_path)
    for s in range(6):
        save_checkpoint(d, s, tree(), keep=3)
    assert list_checkpoints(d) == [3, 4, 5]


def test_shape_mismatch_rejected(tmp_path):
    d = str(tmp_path)
    save_checkpoint(d, 0, tree())
    bad = {"a": torch.zeros(3, 3), "b": {"c": torch.ones(4, dtype=torch.int32)}}
    with pytest.raises(ValueError):
        restore_checkpoint(d, bad, device=CPU)


def test_async_checkpointer(tmp_path):
    d = str(tmp_path)
    ac = AsyncCheckpointer(d, keep=2)
    t = tree()
    ac.save(1, t)
    t["a"].add_(100.0)                          # the snapshot was a copy
    ac.save(2, tree())
    ac.wait()
    assert latest_step(d) == 2 and list_checkpoints(d) == [1, 2]
    got, _, _ = restore_checkpoint(d, tree(), step=1, device=CPU)
    assert torch.equal(got["a"], tree()["a"])


def test_checkpoint_user_hook():
    class MyCk(Checkpoint):
        def __init__(self):
            self.state = 42

        def do_checkpoint(self):
            return {"state": self.state}

        def do_restart(self, st):
            self.state = st["state"]

    ck = MyCk()
    blob = ck.do_checkpoint()
    ck2 = MyCk()
    ck2.state = 0
    ck2.do_restart(blob)
    assert ck2.state == 42
    assert Checkpoint.DoCheckpoint is Checkpoint.do_checkpoint


def test_plan_recovery_modes():
    tids = {0: [0, 1], 1: [2, 3], 2: [4, 5]}
    for mode in ("single", "multi"):
        ours = plan_recovery([1], [0, 1, 2], tids, mode=mode)
        theirs = jft.plan_recovery([1], [0, 1, 2], tids, mode=mode)
        assert (ours.reassignment, ours.new_world) == (theirs.reassignment, theirs.new_world)
    assert set(plan_recovery([1], [0, 1, 2], tids, mode="multi").reassignment.values()) == {0, 2}
    with pytest.raises(RuntimeError):
        plan_recovery([0, 1, 2], [0, 1, 2], tids)
    with pytest.raises(ValueError):
        plan_recovery([1], [0, 1, 2], tids, mode="tape")


def test_rebalance_batch():
    for args in ((256, 16, 8), (256, 16, 15), (7, 7, 9)):
        assert rebalance_batch(*args) == jft.rebalance_batch(*args)
    assert rebalance_batch(256, 16, 15) == 255


# -- test_heartbeat.py's cases -------------------------------------------------


def test_detects_silent_node():
    dead = []
    mon = HeartbeatMonitor([0, 1], timeout=0.15, check_interval=0.02,
                           on_failure=lambda d: dead.extend(d))
    mon.start()
    t0 = time.monotonic()
    while time.monotonic() - t0 < 0.4:
        mon.beat(0)   # node 1 never beats
        time.sleep(0.02)
    mon.stop()
    assert dead == [1]
    assert mon.dead_nodes() == [1]


def test_pause_resume_virtual_barrier():
    mon = HeartbeatMonitor([0], timeout=10)
    assert not mon.should_pause()
    mon.pause()
    assert mon.should_pause()
    mon.resume()
    assert not mon.should_pause()


def test_declare_and_revive():
    dead = []
    mon = HeartbeatMonitor([0, 1], timeout=10, on_failure=lambda d: dead.extend(d))
    mon.declare_dead(0)
    assert dead == [0]
    mon.revive(0)
    assert mon.dead_nodes() == []


def test_beat_carries_metrics_payload():
    """Heartbeats piggyback a metrics snapshot with repro's pinned keys; the
    master reads the latest per node, and a dead node's payload stops."""
    mon = HeartbeatMonitor([0, 1], timeout=10)
    sess = Session(backend="host", n_nodes=2, threads_per_node=1, trace=True, device=CPU)
    try:
        ref = sess.new_array("v", (8,))
        sess.run(lambda ctx, xs: ref.accumulate(xs.sum(axis=0)), data=(torch.ones(2, 8),))
        mon.beat(0, payload=metrics_payload(sess))
        mon.beat(1, payload={"custom": 1})
        p0 = mon.last_payload(0)
        assert tuple(p0) == PAYLOAD_KEYS == jft.PAYLOAD_KEYS
        assert tuple(p0["rebalance"]) == REBALANCE_KEYS == jft.REBALANCE_KEYS
        assert p0["trace_enabled"] and p0["wire_traffic"] == sess.wire_traffic()
        assert p0["barrier_wait_us"]["count"] >= 2
        assert mon.payloads()[1] == {"custom": 1}
        mon.beat(0)                              # a bare beat keeps the payload
        assert mon.last_payload(0) is p0
        mon.declare_dead(1)
        mon.beat(1, payload={"custom": 2})
        assert mon.last_payload(1) == {"custom": 1}
    finally:
        sess.tracer.disable()


# -- the two packages' checkpoints -------------------------------------------


def test_checkpoints_cross_between_packages_bit_exactly(tmp_path):
    """The port writes what repro reads, and repro writes what the port
    reads, bit for bit, with identical manifests and leaf files."""
    rng = np.random.default_rng(0)
    src = _nested(rng)
    ours, theirs = str(tmp_path / "port"), str(tmp_path / "repro")
    save_checkpoint(ours, 5, _as(src, _t), extra={"it": 5})
    jft.save_checkpoint(theirs, 5, _as(src, jnp.asarray), extra={"it": 5})
    assert _manifest(ours, 5) == _manifest(theirs, 5)
    assert [r["path"] for r in _manifest(ours, 5)] == ["a.0", "a.1", "m.b", "m.y", "z"]
    assert _leaf_bytes(ours, 5) == _leaf_bytes(theirs, 5)

    j_tmpl, t_tmpl = _as(src, jnp.asarray), _as(src, _t)
    by_repro, extra, step = jft.restore_checkpoint(ours, j_tmpl)       # port -> repro
    by_port, extra2, step2 = restore_checkpoint(theirs, t_tmpl, device=CPU)  # repro -> port
    assert (extra, step) == (extra2, step2) == ({"it": 5}, 5)
    flat_src = jtree.tree_flatten_with_paths(_as(src, jnp.asarray))
    flat_j = jtree.tree_flatten_with_paths(by_repro)
    flat_t = ttree.tree_flatten_with_paths(by_port)
    for (p, want), (pj, gj), (pt, gt) in zip(flat_src, flat_j, flat_t):
        assert p == pj == pt
        want = np.asarray(want)
        for got in (np.asarray(gj), gt.numpy()):
            assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    assert isinstance(by_port["a"], list) and set(by_port) == {"z", "a", "m"}


def test_bf16_leaf_round_trips_with_repros_bytes(tmp_path):
    """repro saves a bf16 leaf with np.save of an ml_dtypes array; the port
    writes the same bytes (``<V2`` header, manifest ``bfloat16``) and reads
    them back bit for bit, repro's own file included."""
    bits = np.random.default_rng(1).normal(size=(3, 5)).astype(np.float32)
    t = torch.from_numpy(bits).to(torch.bfloat16)
    ours, theirs = str(tmp_path / "port"), str(tmp_path / "repro")
    save_checkpoint(ours, 0, {"w": t, "f": torch.from_numpy(bits)})
    jft.save_checkpoint(theirs, 0, {"w": jnp.asarray(bits.astype(ml_dtypes.bfloat16)),
                                    "f": jnp.asarray(bits)})
    assert _manifest(ours, 0) == _manifest(theirs, 0)
    assert _manifest(ours, 0)[1]["dtype"] == "bfloat16"
    assert _leaf_bytes(ours, 0) == _leaf_bytes(theirs, 0)
    for d in (ours, theirs):
        got, _, _ = restore_checkpoint(d, {"w": t, "f": torch.zeros(3, 5)}, device=CPU)
        assert got["w"].dtype == torch.bfloat16 and torch.equal(got["w"], t)
        assert torch.equal(got["f"], torch.from_numpy(bits))


def test_tree_utils_flatten_as_jax_does():
    src = _nested(np.random.default_rng(2))
    jt, tt = _as(src, jnp.asarray), _as(src, _t)
    assert [p for p, _ in ttree.tree_flatten_with_paths(tt)] == \
        [p for p, _ in jtree.tree_flatten_with_paths(jt)]
    assert ttree.tree_count(tt) == jtree.tree_count(jt)
    assert ttree.tree_bytes(tt) == jtree.tree_bytes(jt)
    zeros = ttree.tree_zeros_like(tt)
    assert ttree.tree_count(zeros) == ttree.tree_count(tt) and list(zeros) == list(tt)
    assert ttree.tree_leaves(ttree.tree_unflatten(tt, ttree.tree_leaves(tt)))[0] is \
        ttree.tree_leaves(tt)[0]
    with pytest.raises(ValueError):
        ttree.tree_unflatten(tt, ttree.tree_leaves(tt) + [1])


def test_elastic_restore_onto_the_ports_mesh(tmp_path):
    """elastic_restore restores onto the mesh's device, every leaf whole
    (a position slices its share at shard_map), the specs checked: an axis
    the mesh lacks or a dimension that does not split evenly raises."""
    from jax.sharding import PartitionSpec as JP
    from repro.core.compat import make_mesh as jmake_mesh

    rng = np.random.default_rng(3)
    src = {"centers": rng.normal(size=(8, 6)).astype(np.float32),
           "ranks": rng.random(12).astype(np.float32)}
    d = str(tmp_path)
    save_checkpoint(d, 1, _as(src, _t))
    mesh = make_mesh((4,), ("data",), device=CPU)
    specs = {"centers": P("data", None), "ranks": P("data")}
    got, _, step = elastic_restore(d, _as(src, _t), mesh, specs)
    jgot, _, _ = jft.elastic_restore(d, _as(src, jnp.asarray), jmake_mesh((1,), ("data",)),
                                     {"centers": JP("data", None), "ranks": JP("data")})
    assert step == 1
    for k in src:
        assert got[k].device.type == "cpu" and got[k].numpy().tobytes() == \
            np.asarray(jgot[k]).tobytes()
    assert torch.equal(reshard_tree(got, mesh, P())["ranks"], got["ranks"])
    with pytest.raises(ValueError, match="does not split evenly"):
        reshard_tree({"x": torch.ones(6)}, mesh, P("data"))
    with pytest.raises(ValueError, match="axes"):
        reshard_tree({"x": torch.ones(8)}, mesh, P("model"))
    with pytest.raises(ValueError, match="more parts"):
        reshard_tree({"x": torch.ones(8)}, mesh, P("data", None))


def test_session_recovery_matches_repro_on_small_kmeans():
    """session_recovery over a small kmeans session, single and multi: the
    same plan (reassignment, world, moved names and epochs) as repro's, and
    the recovered session's centers within kmeans' tolerance of repro's."""
    from repro.analytics import kmeans as jkmeans
    from repro.data import kmeans_dataset
    from repro_torch.analytics import kmeans

    x, _, _ = kmeans_dataset(600, 8, 4, seed=0)
    for mode in ("single", "multi"):
        runs = {}
        for name, make, fit, recover in (
                ("repro", JSession, jkmeans.fit, jft.session_recovery),
                ("port", lambda **kw: Session(device=CPU, **kw), kmeans.fit, session_recovery)):
            sess = make(backend="host", n_nodes=4, threads_per_node=1, shards=4)
            fit(x, 4, iters=1, seed=0, session=sess)
            for i in range(24):                          # names on every shard
                sess.store.def_global(f"state{i}", np.full(4, i, np.float32))
            plan, recovered = recover(sess, [2], mode=mode)
            centers, _ = fit(x, 4, iters=3, seed=0, session=recovered)
            runs[name] = (plan.reassignment, plan.new_world, dict(plan.migration.moved),
                          dict(plan.migration.epochs), recovered.backend.n_threads,
                          np.asarray(centers))
        assert runs["port"][:5] == runs["repro"][:5]
        assert runs["port"][2] and all(src == 2 for src, _ in runs["port"][2].values())
        np.testing.assert_allclose(runs["port"][5], runs["repro"][5], rtol=1e-4, atol=1e-5)


def test_restore_defaults_to_the_card(tmp_path, monkeypatch):
    save_checkpoint(str(tmp_path), 0, tree())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        restore_checkpoint(str(tmp_path), tree())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        reshard_tree(tree(), make_mesh((1,), ("data",)), P())


def test_fault_tolerance_drill_example():
    """examples/torch_fault_tolerance_drill.py runs green at its small size
    on the CPU: heartbeat, both recoveries, checkpoint exactness."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "examples", "torch_fault_tolerance_drill.py"),
         "--device", "cpu"],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    out = proc.stdout
    assert "heartbeat detected failures: [[2]]" in out
    assert "single-node recovery" in out and "multi-node recovery" in out
    assert "restores bit-exact: True" in out
