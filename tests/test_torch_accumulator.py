"""repro_torch's host DAddAccumulator against repro's, on the same inputs.

Wire counts, branch decisions and pair counts must be equal; a round whose
contributions arrive in the same order must give the same bits.
"""

import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import AccumMode as JMode  # noqa: E402
from repro.core import DAddAccumulator as JAcc  # noqa: E402
from repro.core import GlobalStore as JStore  # noqa: E402
from repro_torch.core import AccumMode as TMode  # noqa: E402
from repro_torch.core import DAddAccumulator as TAcc  # noqa: E402
from repro_torch.core import GlobalStore as TStore  # noqa: E402
from repro_torch.core.sparse import pair_capacity  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs files in parallel workers, and
    torch's default of one thread per core would oversubscribe the CPU
    under the timing-sensitive tests of other files."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


PKGS = {"jax": (JStore, JAcc, JMode, jnp.asarray, {}),
        "torch": (TStore, TAcc, TMode, torch.from_numpy, {"device": "cpu"})}


def run_round(pkg, mode, vecs, *, k=None, fused=True, n_nodes=2, rounds=1):
    """One accumulator, len(vecs) threads, contributions arriving in list
    order (each thread starts once its predecessor has contributed), so the
    round's stacking order is fixed and results comparable bit for bit."""
    Store, Acc, Mode, conv, kw = PKGS[pkg]
    n = len(vecs)
    store = Store(**kw)
    shape = np.shape(vecs[0])
    if shape:
        store.new_array("out", shape)
    else:
        store.def_global("out", 0.0)
    acc = Acc(store, "out", n, n_nodes, Mode(mode), k=k, fused=fused)
    for _ in range(rounds):
        threads = []
        for i, v in enumerate(vecs):
            t = threading.Thread(target=acc.accumulate, args=(conv(np.asarray(v)),))
            t.start()
            threads.append(t)
            deadline = time.time() + 10
            while acc._count < i + 1 and i + 1 < n and time.time() < deadline:
                time.sleep(0.001)
        for t in threads:
            t.join(10)
            assert not t.is_alive()
    return np.asarray(store.get("out")), acc


def both(mode, vecs, **kw):
    (oj, aj), (ot, at) = run_round("jax", mode, vecs, **kw), run_round("torch", mode, vecs, **kw)
    assert aj.bytes_transferred == at.bytes_transferred
    assert aj.rounds == at.rounds
    assert aj.last_pair_counts == at.last_pair_counts
    assert (aj.last_mode.value if aj.last_mode else None) == \
        (at.last_mode.value if at.last_mode else None)
    return oj, ot, at


def _sparse_vecs(V, N, nnz=3):
    vecs = []
    for i in range(N):
        v = np.zeros(V, np.float32)
        v[i * nnz: (i + 1) * nnz] = float(i + 1)
        vecs.append(v)
    return vecs


def _dense_vecs(V, N, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=V).astype(np.float32) for _ in range(N)]


@pytest.mark.parametrize("mode", [m.value for m in TMode])
def test_wire_counts_and_sums_equal_every_mode(mode):
    """(2N+1)V, (N+1)V and Σ2·pairs+V, equal to repro's to the element;
    sums equal to the bit with arrivals in the same order."""
    V, N = 1024, 4
    for vecs in (_sparse_vecs(V, N), _dense_vecs(V, N)):
        oj, ot, acc = both(mode, vecs, k=8)
        assert np.array_equal(oj, ot)
    if mode == "gather_all":
        assert acc.bytes_transferred == (2 * N + 1) * V
    elif mode in ("reduce_scatter", "hierarchical"):
        assert acc.bytes_transferred == (N + 1) * V


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("V,N,k", [(1024, 4, 8), (1000, 3, 50), (5000, 4, 1200)])
def test_sparse_round_bitexact(fused, V, N, k):
    """Lossy (dense inputs) and lossless rounds, fused and unfused."""
    for vecs in (_sparse_vecs(V, N), _dense_vecs(V, N, seed=V)):
        oj, ot, acc = both("sparse", vecs, k=k, fused=fused)
        assert np.array_equal(oj, ot)
        assert acc.last_pair_counts == [pair_capacity(V, k)] * N
        assert acc.bytes_transferred == N * 2 * pair_capacity(V, k) + V


def test_auto_branch_decisions_equal():
    V, N, k = 1024, 4, 8
    for vecs, expect in ((_sparse_vecs(V, N), "sparse"),
                         ([np.ones(V, np.float32)] * N, "reduce_scatter"),
                         (_sparse_vecs(V, N)[:-1] + [np.ones(V, np.float32)],
                          "reduce_scatter")):
        oj, ot, acc = both("auto", vecs, k=k)
        assert acc.last_mode.value == expect
        assert np.array_equal(oj, ot)
    # k=None defaults to ~V/4 per round, as in repro
    _, _, acc = both("auto", _sparse_vecs(V, N))
    assert acc.last_mode == TMode.SPARSE


@pytest.mark.parametrize("V,N", [(1024, 4), (4097, 3), (1, 2), (3000, 7)])
def test_auto_dense_round_bitexact(V, N):
    """An AUTO round on dense contributions takes the dense branch, folded by
    the accumulate_blocked route: the same bits, wire count and last_mode as
    repro's fold, in the same arrival order."""
    oj, ot, acc = both("auto", _dense_vecs(V, N, seed=V))
    assert acc.last_mode == TMode.REDUCE_SCATTER
    assert np.array_equal(oj, ot)
    assert acc.bytes_transferred == (N + 1) * V


def test_dense_branch_routes_by_dtype(monkeypatch):
    """A buffered dense round of float32 contributions goes through
    ops.accumulate; any other dtype keeps repro's fold, which rounds after
    each add (bf16: 1 + 2^-9 + 2^-9 + 2^-9 stays 1, where an fp32 sum
    rounded once would give 1 + 2^-7).  The fixed dense modes keep their
    running sum and never call it."""
    import repro_torch.core.accumulator as tacc
    calls = []
    real = tacc.accumulate_rows
    monkeypatch.setattr(tacc, "accumulate_rows",
                        lambda rows: calls.append(rows[0].dtype) or real(rows))

    def run(mode, dtype, vals):
        store = TStore(device="cpu")
        store.new_array("out", (3,))
        acc = TAcc(store, "out", len(vals), 2, mode, k=1)
        ts = []
        for i, v in enumerate(vals):
            ts.append(threading.Thread(target=acc.accumulate,
                                       args=(torch.full((3,), v, dtype=dtype),)))
            ts[-1].start()
            deadline = time.time() + 10
            while acc._count < i + 1 and i + 1 < len(vals) and time.time() < deadline:
                time.sleep(0.001)
        for t in ts:
            t.join(10)
            assert not t.is_alive()
        return store.get("out"), acc

    vals = [1.0, 2.0 ** -9, 2.0 ** -9, 2.0 ** -9]
    out, acc = run(TMode.AUTO, torch.bfloat16, vals)
    assert acc.last_mode == TMode.REDUCE_SCATTER and calls == []
    assert out.dtype == torch.bfloat16 and out.tolist() == [1.0] * 3
    ref = jnp.asarray([1.0] * 3, jnp.bfloat16)
    for v in vals[1:]:
        ref = ref + jnp.asarray([v] * 3, jnp.bfloat16)
    assert np.array_equal(out.float().numpy(), np.asarray(ref, np.float32))
    out, acc = run(TMode.AUTO, torch.float32, vals)
    assert calls == [torch.float32] and acc.last_mode == TMode.REDUCE_SCATTER
    assert out.tolist() == [1.0 + 3 * 2.0 ** -9] * 3
    run(TMode.REDUCE_SCATTER, torch.float32, vals)
    assert calls == [torch.float32]


def test_scalar_and_matrix_contributions():
    oj, ot, acc = both("auto", [np.float32(2.0), np.float32(3.0)])
    assert float(ot) == 5.0 and acc.last_mode == TMode.REDUCE_SCATTER
    mat = np.zeros((4, 8), np.float32)
    mat[1, 2], mat[3, 7] = 5.0, -1.0
    oj, ot, _ = both("sparse", [mat, mat], k=4)
    assert ot.shape == (4, 8) and np.array_equal(oj, ot)


def test_multi_round_accounting_resets():
    V, N, k = 512, 2, 4
    v = np.zeros(V, np.float32)
    v[:2] = 1.0
    (oj, aj), (ot, at) = (run_round(p, "sparse", [v] * N, k=k, rounds=3)
                          for p in ("jax", "torch"))
    assert at.rounds == aj.rounds == 3
    assert at.bytes_transferred == aj.bytes_transferred == 3 * (N * 2 * pair_capacity(V, k) + V)
    assert np.array_equal(oj, ot)


def test_sparse_requires_budget():
    store = TStore(device="cpu")
    store.new_array("out", (8,))
    with pytest.raises(ValueError, match="top-k budget"):
        TAcc(store, "out", 2, 2, TMode.SPARSE)


@pytest.mark.parametrize("second", [np.ones(4, np.float32), np.ones((8, 1), np.float32)])
def test_ragged_round_aborts_and_poisons(second):
    """As in repro: the ragged arrival raises ValueError, the parked peer is
    released with BrokenBarrierError, nothing is published, and a retry
    raises RuntimeError instead of publishing."""
    store = TStore(device="cpu")
    store.new_array("out", (8,))
    acc = TAcc(store, "out", 2, 2, TMode.REDUCE_SCATTER)
    peer_errors = []

    def peer():
        try:
            acc.accumulate(torch.ones(8))
        except threading.BrokenBarrierError as e:
            peer_errors.append(e)

    t = threading.Thread(target=peer)
    t.start()
    deadline = time.time() + 10
    while acc._count == 0 and time.time() < deadline:
        time.sleep(0.005)
    with pytest.raises(ValueError, match="ragged"):
        acc.accumulate(torch.from_numpy(second))
    t.join(10)
    assert not t.is_alive() and len(peer_errors) == 1
    assert acc._count == 0 and acc._vecs == [] and acc._partial is None
    assert acc.rounds == 0
    with pytest.raises(RuntimeError, match="aborted"):
        acc.accumulate(torch.ones(8))
    assert acc.rounds == 0
    assert torch.equal(store.get("out"), torch.zeros(8))


def test_reduce_failure_releases_waiters():
    store = TStore(device="cpu")
    store.new_array("out", (8,))
    acc = TAcc(store, "out", 2, 2, TMode.AUTO, k=0)
    peer_errors = []

    def peer():
        try:
            acc.accumulate(torch.ones(8))
        except threading.BrokenBarrierError as e:
            peer_errors.append(e)

    t = threading.Thread(target=peer)
    t.start()
    deadline = time.time() + 10
    while acc._count == 0 and time.time() < deadline:
        time.sleep(0.005)
    with pytest.raises(ValueError, match="budget"):
        acc.accumulate(torch.ones(8))
    t.join(10)
    assert not t.is_alive() and len(peer_errors) == 1


def test_dense_sum_never_writes_into_a_contribution():
    """The first contribution is the caller's tensor: the running sum must
    be a new tensor, not an in-place add into it."""
    store = TStore(device="cpu")
    store.new_array("out", (16,))
    acc = TAcc(store, "out", 3, 2, TMode.REDUCE_SCATTER)
    vecs = [torch.full((16,), float(i + 1)) for i in range(3)]
    snapshot = [v.clone() for v in vecs]
    ts = [threading.Thread(target=acc.accumulate, args=(v,)) for v in vecs]
    [t.start() for t in ts]
    [t.join(10) for t in ts]
    assert all(torch.equal(v, s) for v, s in zip(vecs, snapshot))
    assert torch.equal(store.get("out"), torch.full((16,), 6.0))
