"""The port's SPMD backend against repro's, on the same numpy inputs.

repro's SPMD runs once, in a subprocess with 8 forced host devices (its
mesh needs them before jax is imported), and saves every reference to an
``.npz``; the port runs its mesh positions as threads on the CPU.

Tolerances: the SPMD accumulate layer is exact on integer-valued inputs and
within rtol 1e-6 on random floats (the dense sums may add in another order);
a sparse round is bit-exact (the same pairs, densified in axis-index order).
Whole app runs hold PERF.md §2's limits: rtol 1e-5, atol 1e-6; kmeans'
centers 1e-4 / 1e-5; nmf's Q 1e-4 and its loss 1e-2.  Wire traffic, rounds,
per-shard traffic and the ``spmd.*`` counters are equal to the element.
"""

import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from conftest import run_subprocess_devices  # noqa: E402
from repro_torch.analytics import kmeans, logreg, nmf, pagerank  # noqa: E402
from repro_torch.core import (  # noqa: E402
    Session, SpmdBackend, accumulate, accumulate_scatter, accumulate_tree, make_mesh,
    shard_map, spmd_threads)
from repro_torch.core.compat import P  # noqa: E402
from repro_torch.core.session import SpmdTraffic  # noqa: E402
from repro_torch.core.accumulator import AccumMode  # noqa: E402
from repro_torch.data import (  # noqa: E402
    kmeans_dataset, logreg_dataset, nmf_dataset, powerlaw_graph)

CPU = "cpu"
APP_TOL = dict(rtol=1e-5, atol=1e-6)
KMEANS_TOL = dict(rtol=1e-4, atol=1e-5)
COUNTERS = ("spmd.scan_sites", "spmd.scan_trips", "spmd.joins", "spmd.collective_elements")

# repro's side: every reference the tests below hold the port against
_REFERENCE = r'''
import warnings
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro.core import Session, accumulate, accumulate_scatter, accumulate_tree, spmd_threads
from repro.core.compat import make_mesh, shard_map
from repro.core.session import SpmdBackend
from repro.analytics import kmeans, logreg, nmf, pagerank
from repro.data import kmeans_dataset, logreg_dataset, nmf_dataset, powerlaw_graph

out = {}
mesh42 = make_mesh((4, 2), ("data", "model"))
mesh4 = make_mesh((4,), ("data",), devices=jax.devices()[:4])

def per_pos(fn, x):
    f = shard_map(lambda v: fn(v[0])[None], mesh=mesh42, in_specs=P("data", None),
                  out_specs=P("data", None), check_vma=False)
    return np.asarray(jax.jit(f)(jnp.asarray(x)))

V = 64
x_int = np.arange(4 * V, dtype=np.float32).reshape(4, V)
xs = np.zeros((4, V), np.float32)
for i in range(4):
    xs[i, i * 3:i * 3 + 2] = i + 1.0
x_rand = np.random.default_rng(0).normal(size=(4, 66)).astype(np.float32)
out["in_int"], out["in_xs"], out["in_rand"] = x_int, xs, x_rand
for name, x in (("int", x_int), ("rand", x_rand)):
    for mode in ("gather_all", "reduce_scatter", "hierarchical"):
        out[f"acc_{name}_{mode}"] = per_pos(lambda v: accumulate(v, "data", mode, inner_axis="data"), x)
    out[f"acc_{name}_hier_outer"] = per_pos(
        lambda v: accumulate(v, "data", "hierarchical", inner_axis="data", outer_axis="model"), x)
    out[f"scatter_{name}"] = per_pos(lambda v: accumulate_scatter(v, "data"), x)
for name, x in (("xs", xs), ("rand", x_rand)):
    out[f"sparse_{name}"] = per_pos(lambda v: accumulate(v, "data", "sparse", k=8), x)
def auto(v):
    t, b = accumulate(v, "data", "auto", k=8, with_branch=True)
    return jnp.concatenate([t, b.astype(jnp.float32)[None]])
for name, x in (("int", x_int), ("xs", xs)):
    out[f"auto_{name}"] = per_pos(auto, x)
out["in_tree_w"] = np.random.default_rng(1).normal(size=(4, 3, 5)).astype(np.float32)
out["in_tree_b"] = np.random.default_rng(2).normal(size=(4, 7)).astype(np.float32)
f = shard_map(lambda w, b: jax.tree.map(lambda l: l[None], accumulate_tree({"w": w[0], "b": b[0]}, "data")),
              mesh=mesh42, in_specs=(P("data"), P("data")), out_specs=P("data"), check_vma=False)
t = jax.jit(f)(out["in_tree_w"], out["in_tree_b"])
out["tree_w"], out["tree_b"] = np.asarray(t["w"]), np.asarray(t["b"])
f = spmd_threads(lambda tid, v: jnp.full((1,), tid, jnp.int32), mesh42, ("data", "model"),
                 in_specs=P(("data", "model")), out_specs=P(("data", "model")))
out["tids"] = np.asarray(jax.jit(f)(jnp.zeros(8)))

def spmd_session(trace=False):
    return Session(backend=SpmdBackend(mesh=mesh4), trace=trace)

def record(prefix, sess):
    out[prefix + "_wire"] = np.int64(sess.wire_traffic())
    out[prefix + "_rounds"] = np.int64(sess.backend.stats.rounds)
    shards = sess.metrics()["shards"]
    out[prefix + "_shard_wire"] = np.array([shards[s]["wire_traffic"] for s in sorted(shards)])
    if sess.tracer.enabled:
        c = sess.tracer.counters()
        for key in ("spmd.scan_sites", "spmd.scan_trips", "spmd.joins", "spmd.collective_elements"):
            out[prefix + "_" + key] = np.float64(c.get(key, 0))
        sess.tracer.disable()

out["in_sess_rows"] = np.random.default_rng(3).normal(size=(4, 3000)).astype(np.float32)
sess = spmd_session(trace=True)
o = sess.new_array("o", (3000,), sparse_k=300)
res = sess.run(lambda ctx, xs: o.accumulate(xs[0], mode="sparse"), data=(out["in_sess_rows"],))
out["sess_sparse"] = np.stack([np.asarray(r) for r in res])
out["sess_sparse_store"] = np.asarray(o.get())
record("sess_sparse", sess)

auto_rows = np.zeros((4, 512), np.float32)
for t in range(4):
    auto_rows[t, t * 3: t * 3 + 3] = float(t + 1)
out["in_auto_sparse"] = out["in_auto_iter"] = auto_rows
out["in_auto_dense"] = np.random.default_rng(1).normal(size=(4, 512)).astype(np.float32)
for prefix, iters in (("auto_sparse", None), ("auto_dense", None), ("auto_iter", 3)):
    sess = spmd_session(trace=True)
    o = sess.new_array("o", (512,), sparse_k=8)
    if iters is None:
        proc = lambda ctx, xs: o.accumulate(xs[0], mode="auto")
    else:
        def proc(ctx, xs):
            return ctx.iterate(lambda c: c + o.accumulate(xs[0], mode="auto"), jnp.zeros((512,)), iters)
    res = sess.run(proc, data=(out["in_" + prefix],))
    out[prefix] = np.stack([np.asarray(r) for r in res])
    record(prefix, sess)

sess = spmd_session(trace=True)
o = sess.new_array("out", (16,))
def nested(ctx):
    def outer(c):
        return ctx.fori(lambda i, d: d + o.accumulate(jnp.ones(16) * (ctx.tid + 1))[0] + i, c, 2)
    return ctx.iterate(outer, jnp.float32(0.0), 3)
out["nested"] = np.array([float(r) for r in sess.run(nested)])
record("nested", sess)

sess = spmd_session()
c = sess.def_global("c", jnp.int32(5))
res = sess.run(lambda ctx: ctx.iterate(lambda _: c.inc(3), jnp.int32(0), 2))
out["inc_result"] = np.array([int(r) for r in res])
out["inc_store"] = np.int64(c.get())

sess = spmd_session()
w = sess.def_global("w", jnp.ones(8))
acc = sess.new_array("acc", (8,))
def proc(ctx, xs):
    def step(theta):
        total = acc.accumulate(xs.sum(0) + w.get())
        w.set(total / ctx.n_threads)
        return theta + total
    return ctx.iterate(step, jnp.zeros(8), 5)
with warnings.catch_warnings(record=True) as rec:
    warnings.simplefilter("always")
    res = sess.run(proc, data=(np.arange(18 * 8, dtype=np.float32).reshape(18, 8) / 10,))
assert any("2 ragged row" in str(r.message) for r in rec)
out["ragged"] = np.stack([np.asarray(r) for r in res])
out["ragged_w"] = np.asarray(w.get())
record("ragged", sess)

x, y, _ = logreg_dataset(400, 24, seed=0)
for mode, k in (("reduce_scatter", None), ("sparse", 8), ("auto", 8)):
    sess = spmd_session(trace=True)
    out[f"logreg_{mode}"], _ = logreg.fit(x, y, iters=8, lr=1e-3, mode=mode, k=k, session=sess)
    record(f"logreg_{mode}", sess)
xk, _, _ = kmeans_dataset(300, 8, 4, seed=6)
for kern in (False, True):
    sess = spmd_session(trace=True)
    out[f"kmeans_{int(kern)}"], _ = kmeans.fit(xk, 4, iters=5, seed=6, use_kernel=kern, session=sess)
    record(f"kmeans_{int(kern)}", sess)
r, _, _ = nmf_dataset(120, 32, 4, seed=2)
for mode in ("reduce_scatter", "auto"):
    sess = spmd_session(trace=True)
    out[f"nmf_{mode}_p"], out[f"nmf_{mode}_q"], _ = nmf.fit(r, 4, iters=10, seed=3, mode=mode,
                                                            session=sess)
    record(f"nmf_{mode}", sess)
edges = powerlaw_graph(300, 5, seed=3)
for mode, k in (("auto", None), ("sparse", 75), ("gather_all", None)):
    sess = spmd_session(trace=True)
    out[f"pagerank_{mode}"], _ = pagerank.fit(edges, 300, iters=8, mode=mode, k=k, session=sess)
    record(f"pagerank_{mode}", sess)
np.savez("@OUT@", **out)
print("SPMD_REFERENCE_OK")
'''


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs files in parallel workers, and
    torch's default of one thread per core would oversubscribe the CPU
    under the timing-sensitive tests of other files."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """repro's SPMD on 8 forced host devices, run once for the module."""
    path = tmp_path_factory.mktemp("spmd") / "reference.npz"
    out = run_subprocess_devices(_REFERENCE.replace("@OUT@", str(path)), n_devices=8)
    assert "SPMD_REFERENCE_OK" in out
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _mesh(shape=(4,), names=("data",)):
    return make_mesh(shape, names, device=CPU)


def _spmd(trace=False, **kw):
    return Session(backend=SpmdBackend(mesh=_mesh()), trace=trace, **kw)


def _per_pos(fn, x):
    """``fn`` of each position's row on the (4, 2) mesh, as repro's test
    shard_maps it: position (d, m) takes row d; rows of the output by d."""
    f = shard_map(lambda v: fn(v[0])[None], mesh=_mesh((4, 2), ("data", "model")),
                  in_specs=P("data", None), out_specs=P("data", None))
    return f(torch.from_numpy(x)).numpy()


def _record(sess) -> dict:
    shards = sess.metrics()["shards"]
    got = {"wire": sess.wire_traffic(), "rounds": sess.backend.stats.rounds,
           "shard_wire": np.array([shards[s]["wire_traffic"] for s in sorted(shards)])}
    if sess.tracer.enabled:
        counters = sess.tracer.counters()
        got.update({key: counters.get(key, 0) for key in COUNTERS})
        sess.tracer.disable()
    return got


def _check_record(ref, prefix, got, counters=True) -> None:
    assert got["wire"] == ref[prefix + "_wire"]
    assert got["rounds"] == ref[prefix + "_rounds"]
    np.testing.assert_array_equal(got["shard_wire"], ref[prefix + "_shard_wire"])
    if counters:
        for key in COUNTERS:
            assert got[key] == ref[f"{prefix}_{key}"], key


# -- the SPMD accumulate layer -----------------------------------------------


@pytest.mark.parametrize("mode", ["gather_all", "reduce_scatter", "hierarchical", "hier_outer"])
@pytest.mark.parametrize("data", ["int", "rand"])
def test_accumulate_dense_modes(ref, data, mode):
    """Exact on integer-valued inputs, rtol 1e-6 on random floats (V = 66
    pads to a multiple of the axis size)."""
    if mode == "hier_outer":
        fn = lambda v: accumulate(v, "data", "hierarchical", inner_axis="data",  # noqa: E731
                                  outer_axis="model")
    else:
        fn = lambda v: accumulate(v, "data", mode, inner_axis="data")  # noqa: E731
    got = _per_pos(fn, ref[f"in_{data}"])
    want = ref[f"acc_{data}_{mode}"]
    if data == "int":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("data", ["int", "rand"])
def test_accumulate_scatter_chunk_per_position(ref, data):
    got = _per_pos(lambda v: accumulate_scatter(v, "data"), ref[f"in_{data}"])
    assert got.shape == ref[f"scatter_{data}"].shape
    np.testing.assert_allclose(got, ref[f"scatter_{data}"], rtol=1e-6 if data == "rand" else 0)


@pytest.mark.parametrize("data", ["xs", "rand"])
def test_accumulate_sparse_bitexact(ref, data):
    """Lossless (xs) and lossy (rand) top-8 pairs, densified bit-exactly."""
    got = _per_pos(lambda v: accumulate(v, "data", "sparse", k=8), ref[f"in_{data}"])
    np.testing.assert_array_equal(got, ref[f"sparse_{data}"])


@pytest.mark.parametrize("data,branch", [("int", False), ("xs", True)])
def test_accumulate_auto_branch(ref, data, branch):
    def fn(v):
        total, took = accumulate(v, "data", "auto", k=8, with_branch=True)
        assert took is branch
        return torch.cat([total, torch.tensor([float(took)])])
    got = _per_pos(fn, ref[f"in_{data}"])
    np.testing.assert_array_equal(got, ref[f"auto_{data}"])


def test_accumulate_tree(ref):
    f = shard_map(lambda w, b: {k: v[None] for k, v in accumulate_tree(
                      {"w": w[0], "b": b[0]}, "data").items()},
                  mesh=_mesh((4, 2), ("data", "model")), in_specs=(P("data"), P("data")),
                  out_specs=P("data"))
    got = f(torch.from_numpy(ref["in_tree_w"]), torch.from_numpy(ref["in_tree_b"]))
    np.testing.assert_allclose(got["w"].numpy(), ref["tree_w"], rtol=1e-6)
    np.testing.assert_allclose(got["b"].numpy(), ref["tree_b"], rtol=1e-6)


def test_with_branch_rejected_outside_auto():
    # the mode check fires before any collective, so no mesh is needed
    for mode in (AccumMode.SPARSE, AccumMode.REDUCE_SCATTER):
        with pytest.raises(ValueError, match="with_branch"):
            accumulate(torch.ones(4), "data", mode, k=2, with_branch=True)


def test_collectives_outside_a_position_raise():
    with pytest.raises(RuntimeError, match="mesh position"):
        accumulate(torch.ones(4), "data")


def test_spmd_threads_tid_order(ref):
    f = spmd_threads(lambda tid, v: torch.full((1,), tid, dtype=torch.int32),
                     _mesh((4, 2), ("data", "model")), ("data", "model"),
                     in_specs=P(("data", "model")), out_specs=P(("data", "model")))
    got = f(torch.zeros(8)).numpy()
    np.testing.assert_array_equal(got, ref["tids"])
    np.testing.assert_array_equal(got, np.arange(8))


# -- Session(backend="spmd") --------------------------------------------------


def test_session_sparse_round_bitexact(ref):
    sess = _spmd(trace=True)
    o = sess.new_array("o", (3000,), sparse_k=300)
    res = sess.run(lambda ctx, xs: o.accumulate(xs[0], mode="sparse"),
                   data=(ref["in_sess_rows"],))
    np.testing.assert_array_equal(np.stack([r.numpy() for r in res]), ref["sess_sparse"])
    np.testing.assert_array_equal(o.get().numpy(), ref["sess_sparse_store"])
    # one tensor for every position: the densified sum is computed once
    assert all(r is res[0] for r in res)
    spans = sess.tracer.spans("spmd", "spmd.execute")
    assert len(spans) == 1 and spans[0]["args"]["threads"] == 4
    _check_record(ref, "sess_sparse", _record(sess))


@pytest.mark.parametrize("prefix", ["auto_sparse", "auto_dense", "auto_iter"])
def test_auto_traffic_settles_to_the_branch_taken(ref, prefix):
    sess = _spmd(trace=True)
    o = sess.new_array("o", (512,), sparse_k=8)
    if prefix == "auto_iter":
        def proc(ctx, xs):
            return ctx.iterate(lambda c: c + o.accumulate(xs[0], mode="auto"),
                               torch.zeros(512), 3)
    else:
        def proc(ctx, xs):
            return o.accumulate(xs[0], mode="auto")
    res = sess.run(proc, data=(ref["in_" + prefix],))
    np.testing.assert_allclose(np.stack([r.numpy() for r in res]), ref[prefix], rtol=1e-6)
    _check_record(ref, prefix, _record(sess))


def test_nested_fori_counters_and_traffic_times_trips(ref):
    """A fori inside iterate: sites counted once each, trips as the product
    of the trip counts, traffic charged for every executed round."""
    sess = _spmd(trace=True)
    o = sess.new_array("out", (16,))

    def proc(ctx):
        def outer(c):
            return ctx.fori(lambda i, d: d + o.accumulate(
                torch.ones(16) * (ctx.tid + 1))[0] + i, c, 2)
        return ctx.iterate(outer, torch.tensor(0.0), 3)

    res = sess.run(proc)
    np.testing.assert_array_equal([float(r) for r in res], ref["nested"])
    got = _record(sess)
    _check_record(ref, "nested", got)
    assert got["spmd.scan_sites"] == 2 and got["spmd.scan_trips"] == 3 + 3 * 2
    assert got["wire"] == (4 + 1) * 16 * 6


def test_traffic_multiplied_by_trip_count():
    sess = _spmd()
    out = sess.new_array("out", (16,))
    sess.run(lambda ctx: ctx.iterate(lambda c: c + out.accumulate(torch.ones(16))[0], 0.0, 7))
    assert sess.backend.stats.rounds == 7
    assert sess.wire_traffic() == (4 + 1) * 16 * 7


def test_traffic_scalar_account():
    stats = SpmdTraffic()
    stats.account(AccumMode.REDUCE_SCATTER, 4, 1, None)
    assert stats.bytes_transferred == 5 and stats.rounds == 1


def test_scalar_accumulate():
    sess = _spmd()
    c = sess.new_array("c", ())
    res = sess.run(lambda ctx: ctx.iterate(
        lambda t: t + c.accumulate(torch.tensor(2.0)), torch.tensor(0.0), 3))
    assert [float(r) for r in res] == [2.0 * 4 * 3] * 4
    assert float(c.get()) == 2.0 * 4
    assert sess.wire_traffic() == (4 + 1) * 1 * 3


def test_inc_advances_by_n_times_amount(ref):
    sess = _spmd()
    c = sess.def_global("c", torch.tensor(5, dtype=torch.int32))
    res = sess.run(lambda ctx: ctx.iterate(lambda _: c.inc(3), torch.tensor(0), 2))
    np.testing.assert_array_equal([int(r) for r in res], ref["inc_result"])
    assert int(c.get()) == ref["inc_store"] == 5 + 2 * 4 * 3


def test_ragged_rows_warn_and_trim(ref):
    """18 rows over 4 positions: 2 dropped with repro's warning text."""
    sess = _spmd()
    w = sess.def_global("w", torch.ones(8))
    acc = sess.new_array("acc", (8,))

    def proc(ctx, xs):
        def step(theta):
            total = acc.accumulate(xs.sum(0) + w.get())
            w.set(total / ctx.n_threads)
            return theta + total
        return ctx.iterate(step, torch.zeros(8), 5)

    data = np.arange(18 * 8, dtype=np.float32).reshape(18, 8) / 10
    with pytest.warns(UserWarning, match="dropping 2 ragged row"):
        res = sess.run(proc, data=(data,))
    np.testing.assert_allclose(np.stack([r.numpy() for r in res]), ref["ragged"], rtol=1e-6)
    np.testing.assert_allclose(w.get().numpy(), ref["ragged_w"], rtol=1e-6)
    _check_record(ref, "ragged", _record(sess), counters=False)


def test_positions_get_their_rows_and_broadcasts_whole():
    sess = _spmd()
    data = np.arange(12, dtype=np.float32).reshape(6, 2)   # 6 rows: 2 dropped
    with pytest.warns(UserWarning, match="ragged"):
        res = sess.run(lambda ctx, xs, b: (ctx.tid, xs.clone(), b.sum()),
                       data=(data,), broadcast=(np.ones(5, np.float32),))
    assert [r[0] for r in res] == [0, 1, 2, 3]
    for tid, rows, b in res:
        np.testing.assert_array_equal(rows.numpy(), data[tid:tid + 1])
        assert float(b) == 5.0


def test_failing_position_makes_join_raise_without_hanging():
    sess = _spmd()
    out = sess.new_array("out", (8,))

    def proc(ctx):
        if ctx.tid == 2:
            raise ValueError("boom")
        return out.accumulate(torch.ones(8))     # the others wait here

    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="failed") as info:
        sess.run(proc, timeout=30)
    assert isinstance(info.value.__cause__, ValueError)
    assert time.perf_counter() - t0 < 5
    assert not [t for t in threading.enumerate() if t.name.startswith("mesh-position")]


def test_position_leaving_without_joining_breaks_the_collective():
    sess = _spmd()
    out = sess.new_array("out", (8,))

    def proc(ctx):
        if ctx.tid == 0:
            return None
        return out.accumulate(torch.ones(8))

    with pytest.raises(RuntimeError, match="failed"):
        sess.run(proc, timeout=30)


def test_a_fast_position_does_not_fold_into_the_current_round():
    """Position 0 sleeps before each round; rounds still close one at a time."""
    sess = _spmd()
    out = sess.new_array("out", (4,))

    def proc(ctx):
        def step(i, c):
            if ctx.tid == 0:
                time.sleep(0.01)
            return c + out.accumulate(torch.full((4,), float(i + 1)))
        return ctx.fori(step, torch.zeros(4), 5)

    res = sess.run(proc)
    for r in res:   # sum over rounds of 4 · (i + 1)
        np.testing.assert_array_equal(r.numpy(), np.full(4, 4.0 * 15))


def test_mesh_none_is_one_position_on_the_cpu_and_metrics_say_spmd():
    sess = Session(backend="spmd", device=CPU)
    assert sess.backend.n_threads == sess.backend.n_nodes == 1
    out = sess.new_array("out", (4,))
    sess.run(lambda ctx: out.accumulate(torch.ones(4)))
    m = sess.metrics()
    assert m["backend"] == "spmd" and m["wire_traffic"] == 2 * 4
    assert sum(r["wire_traffic"] for r in m["shards"].values()) == 2 * 4
    assert sess.accumulator("out") is sess.backend.stats
    assert sess.healthy_nodes() == [0] and sess.thread_states() == {}
    with pytest.raises(RuntimeError, match="host backend"):
        sess.kill_node(0)


def test_mesh_device_wins_and_a_mismatch_raises():
    sess = Session(backend=SpmdBackend(mesh=_mesh()))
    assert sess.device == torch.device(CPU) and sess.backend.n_threads == 4
    with pytest.raises(ValueError, match="mesh"):
        Session(backend="spmd", mesh=_mesh(), axis="model", device=CPU)
    meta = make_mesh((2,), ("data",), device="meta")
    with pytest.raises(ValueError, match="mesh is on"):
        Session(backend=SpmdBackend(mesh=meta), device=CPU)


def test_iterate_zero_rounds_and_host_parity():
    sess = _spmd()
    assert [float(r) for r in sess.run(
        lambda ctx: ctx.iterate(lambda c: c + 1.0, torch.tensor(7.0), 0))] == [7.0] * 4

    def program(backend):
        s = (Session(backend=backend, n_nodes=2, threads_per_node=2, device=CPU)
             if backend == "host" else _spmd())
        w = s.def_global("w", torch.arange(4.0))
        acc = s.new_array("acc", (4,))

        def proc(ctx, xs):
            def step(theta):
                cur = w.get()     # read before the round's sync point, as on the host
                total = acc.accumulate(xs.sum(0) * cur)
                w.set(cur * 0.5)
                return theta + total
            return ctx.iterate(step, torch.zeros(4), 4)

        res = s.run(proc, data=(np.ones((8, 4), np.float32),))
        return res[0].numpy(), w.get().numpy(), s.wire_traffic()

    th, wh, wire_h = program("host")
    ts, ws, wire_s = program("spmd")
    np.testing.assert_allclose(ts, th, rtol=1e-6)
    np.testing.assert_allclose(ws, wh, rtol=1e-6)
    assert wire_h == wire_s


# -- the four apps at 4 positions ---------------------------------------------


@pytest.mark.parametrize("mode,k", [("reduce_scatter", None), ("sparse", 8), ("auto", 8)])
def test_logreg_spmd(ref, mode, k):
    x, y, _ = logreg_dataset(400, 24, seed=0)
    sess = _spmd(trace=True)
    th, _ = logreg.fit(x, y, iters=8, lr=1e-3, mode=mode, k=k, session=sess)
    np.testing.assert_allclose(th, ref[f"logreg_{mode}"], **APP_TOL)
    th_h, s_h = logreg.fit(x, y, iters=8, lr=1e-3, mode=mode, k=k, device=CPU)
    np.testing.assert_allclose(th, th_h, **APP_TOL)
    got = _record(sess)
    _check_record(ref, f"logreg_{mode}", got)
    assert got["wire"] == s_h.wire_traffic()


@pytest.mark.parametrize("use_kernel", [False, True])
def test_kmeans_spmd(ref, use_kernel):
    x, _, _ = kmeans_dataset(300, 8, 4, seed=6)
    sess = _spmd(trace=True)
    c, _ = kmeans.fit(x, 4, iters=5, seed=6, use_kernel=use_kernel, session=sess)
    np.testing.assert_allclose(c, ref[f"kmeans_{int(use_kernel)}"], **KMEANS_TOL)
    c_h, s_h = kmeans.fit(x, 4, iters=5, seed=6, use_kernel=use_kernel, device=CPU)
    np.testing.assert_allclose(c, c_h, **KMEANS_TOL)
    got = _record(sess)
    _check_record(ref, f"kmeans_{int(use_kernel)}", got)
    assert got["wire"] == s_h.wire_traffic()


@pytest.mark.parametrize("mode", ["reduce_scatter", "auto"])
def test_nmf_spmd(ref, mode):
    r, _, _ = nmf_dataset(120, 32, 4, seed=2)
    sess = _spmd(trace=True)
    p, q, _ = nmf.fit(r, 4, iters=10, seed=3, mode=mode, session=sess)
    np.testing.assert_allclose(q, ref[f"nmf_{mode}_q"], rtol=1e-4)
    np.testing.assert_allclose(nmf.frob_loss(r, p, q, device=CPU),
                               nmf.frob_loss(r, ref[f"nmf_{mode}_p"], ref[f"nmf_{mode}_q"],
                                             device=CPU), rtol=1e-2)
    p_h, q_h, s_h = nmf.fit(r, 4, iters=10, seed=3, mode=mode, device=CPU)
    np.testing.assert_allclose(q, q_h, rtol=1e-4)
    got = _record(sess)
    _check_record(ref, f"nmf_{mode}", got)
    assert got["wire"] == s_h.wire_traffic()


@pytest.mark.parametrize("mode,k", [("auto", None), ("sparse", 75), ("gather_all", None)])
def test_pagerank_spmd(ref, mode, k):
    edges = powerlaw_graph(300, 5, seed=3)
    sess = _spmd(trace=True)
    rk, _ = pagerank.fit(edges, 300, iters=8, mode=mode, k=k, session=sess)
    np.testing.assert_allclose(rk, ref[f"pagerank_{mode}"], **APP_TOL)
    rk_h, s_h = pagerank.fit(edges, 300, iters=8, mode=mode, k=k, device=CPU)
    np.testing.assert_allclose(rk, rk_h, **APP_TOL)
    got = _record(sess)
    _check_record(ref, f"pagerank_{mode}", got)
    assert got["wire"] == s_h.wire_traffic()


@pytest.mark.parametrize("shape,names", [((4,), ("data",)), ((4, 2), ("data", "model"))])
def test_pagerank_spmd_counts_its_credit_path_once_per_thread_round(shape, names):
    """A mesh with a data axis of 4 is 4 threads, whatever its other axes:
    the positions off the data axis repeat a thread's work, so the ranks and
    the wire traffic are the host's."""
    edges = powerlaw_graph(300, 5, seed=3)
    sess = Session(backend=SpmdBackend(mesh=_mesh(shape, names)))
    rk, _ = pagerank.fit(edges, 300, iters=8, session=sess)
    rk_h, s_h = pagerank.fit(edges, 300, iters=8, device=CPU)
    np.testing.assert_allclose(rk, rk_h, **APP_TOL)
    assert sess.wire_traffic() == s_h.wire_traffic() > 0


# -- fit on a session the caller made ------------------------------------------


def _app_case(app):
    """Arguments, a mode other than the apps' default (so the session's mode
    shows in the traffic), and the result to compare."""
    if app == "logreg":
        x, y, _ = logreg_dataset(200, 16, seed=5)
        return (x, y), dict(iters=6, lr=1e-3, mode="gather_all"), lambda o: o[0]
    if app == "kmeans":
        x, _, _ = kmeans_dataset(300, 8, 4, seed=6)
        return (x, 4), dict(iters=5, seed=6, mode="gather_all"), lambda o: o[0]
    if app == "nmf":
        r, _, _ = nmf_dataset(120, 32, 4, seed=2)
        return (r, 4), dict(iters=5, seed=3, mode="gather_all"), lambda o: o[1]
    return ((powerlaw_graph(300, 5, seed=3), 300), dict(iters=6, mode="gather_all"),
            lambda o: o[0])


_MODULES = {"logreg": logreg, "kmeans": kmeans, "nmf": nmf, "pagerank": pagerank}
_ACCUMULATED = {"logreg": "grad", "kmeans": "partials", "nmf": "q_partials",
                "pagerank": "credits"}


@pytest.mark.parametrize("backend", ["host", "spmd"])
@pytest.mark.parametrize("app", ["logreg", "kmeans", "nmf", "pagerank"])
def test_fit_on_a_given_session_matches_fit(app, backend):
    """``fit(session=...)`` on a host session set to GATHER_ALL, or on an
    SPMD session of a 4-position mesh, gives ``fit(device=CPU)``'s result to
    the app's limit (the threads' sums run in another order), one round of
    the app's accumulator an iteration, and wire traffic."""
    module = _MODULES[app]
    args, kw, pick = _app_case(app)
    if backend == "host":
        sess = Session(backend="host", n_nodes=2, threads_per_node=2,
                       accum_mode="gather_all", device=CPU)
    else:
        sess = _spmd()
    got = module.fit(*args, session=sess, **kw)
    want = module.fit(*args, device=CPU, **kw)
    np.testing.assert_allclose(pick(got), pick(want),
                               **(KMEANS_TOL if app in ("kmeans", "nmf") else APP_TOL))
    accu = sess.accumulator(_ACCUMULATED[app])
    if backend == "host":
        assert accu.mode is AccumMode.GATHER_ALL
    assert accu.rounds == kw["iters"]
    assert sess.wire_traffic() > 0


def test_join_timeout_breaks_the_mesh():
    """A position late past join's timeout breaks the mesh: the positions
    waiting in its collective raise, and join raises."""
    sess = _spmd()
    out = sess.new_array("out", (8,))

    def proc(ctx):
        if ctx.tid == 0:
            time.sleep(1.5)
        return out.accumulate(torch.ones(8))

    with pytest.raises(RuntimeError):
        sess.run(proc, timeout=0.3)
    deadline = time.monotonic() + 10
    while [t for t in threading.enumerate() if t.name.startswith("mesh-position")]:
        assert time.monotonic() < deadline, "a mesh position outlived the run"
        time.sleep(0.05)


def test_collectives_both_layouts_on_a_2d_mesh():
    """all_gather stacked and tiled, psum over each axis and both, and
    psum_scatter tiled and not, on a (2, 3) mesh, against numpy."""
    mesh = _mesh((2, 3), ("a", "b"))
    from repro_torch.core.compat import all_gather, axis_index, psum, psum_scatter

    def body(x):
        i, j = axis_index("a"), axis_index("b")
        v = torch.full((3,), float(10 * i + j))
        return (all_gather(v, "b")[None, None], all_gather(v, "a", tiled=True)[None, None],
                psum(v, "a")[None, None], psum(v, ("a", "b"))[None, None],
                psum_scatter(torch.arange(3.0) + i, "b")[None, None, None],
                psum_scatter(torch.arange(6.0) * (j + 1), "b", tiled=True)[None, None])

    spec = P("a", "b")
    outs = shard_map(body, mesh=mesh, in_specs=P(), out_specs=(spec,) * 6)(torch.zeros(1))
    val = np.array([[10.0 * i + j for j in range(3)] for i in range(2)])
    gb, ga, pa, pab, sc, sct = (o.numpy() for o in outs)
    for i in range(2):
        for j in range(3):
            np.testing.assert_array_equal(gb[i, j], np.repeat(val[i][:, None], 3, 1))
            np.testing.assert_array_equal(ga[i, j], np.repeat(val[:, j], 3))
            np.testing.assert_array_equal(pa[i, j], np.full(3, val[:, j].sum()))
            np.testing.assert_array_equal(pab[i, j], np.full(3, val.sum()))
            assert sc[i, j, 0] == 3 * (j + i)        # entry j of the sum of arange(3) + i
            np.testing.assert_array_equal(sct[i, j], np.arange(6.0)[2 * j:2 * j + 2] * 6)


def test_rendezvous_stress_more_positions_than_cores():
    """16 positions, 200 rounds of psum with a short switch interval: every
    round's sum is exact, so no contribution was lost or folded into
    another round."""
    import sys
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        mesh = _mesh((16,), ("data",))
        from repro_torch.core.compat import axis_index, psum, run_positions

        def body(linear):
            got = []
            for r in range(200):
                got.append(float(psum(torch.tensor(float(r * 16 + axis_index("data"))),
                                      "data")))
            return got

        t0 = time.perf_counter()
        outs = run_positions(mesh, body, timeout=120)
        assert time.perf_counter() - t0 < 120
    finally:
        sys.setswitchinterval(interval)
    want = [float(sum(r * 16 + p for p in range(16))) for r in range(200)]
    for got in outs:
        assert got == want
