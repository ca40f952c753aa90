"""Logistic regression over a sparse design matrix: the CSR row split on
both backends, the plain gradient path on the CPU against the benchmark's
reference and the dense ``fit``, the counters, and (marked ``cuda``) the
margin kernel and the binned kernel with a value an edge against their
plain versions on the card.

The module imports nothing of JAX, so ``pytest -m cuda`` runs it on a GPU
machine.
"""

import os
import sys
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from repro_torch.analytics import logreg  # noqa: E402
from repro_torch.core import Session, telemetry  # noqa: E402
from repro_torch.data import CSRMatrix, partition_rows  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.logreg_margin import ops as margin_ops  # noqa: E402
from repro_torch.kernels.logreg_margin.ops import (  # noqa: E402
    margin_residuals, margin_residuals_plain)
from repro_torch.kernels.pagerank_credits import ops  # noqa: E402
from repro_torch.kernels.pagerank_credits.ops import bin_edges, binned_credits  # noqa: E402
from stepbench.generators import sparse_rows  # noqa: E402
from stepbench.reference import logreg as ref  # noqa: E402

CPU = torch.device("cpu")
ULP = torch.finfo(torch.float32).eps     # one fp32 ulp, relative
F64_EPS = torch.finfo(torch.float64).eps


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs files in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda():
    """The card, decided when the test runs (never at import or collection)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _data(rows=1003, features=2011, nnz=29_431, seed=5, device=CPU):
    """The benchmark's generator at a small size: rows of 29 or 30
    distinct features of Zipf popularity, values not constant within a row,
    labels from a hidden model."""
    cfg = {"matrix": {"rows": rows, "features": features, "nnz": nnz, "zipf_exponent": 1.0}}
    d = sparse_rows.make(cfg, torch.Generator(device=device).manual_seed(seed), device)
    x = CSRMatrix(d["indptr"], d["indices"], d["values"], d["n_features"])
    return x, d["y"], d


def _dense(x: CSRMatrix) -> torch.Tensor:
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    out[x.row_ids(), x.indices.long()] = x.values
    return out


# -- the CSR type and its split ---------------------------------------------------


def test_generator_makes_what_the_configuration_states():
    x, y, _ = _data()
    assert x.shape == (1003, 2011) and x.nnz == 29_431
    lengths = torch.diff(x.indptr)
    assert set(lengths.tolist()) == {29, 30} and int(lengths.sum()) == 29_431
    dense = _dense(x)
    assert int((dense != 0).sum()) == 29_431                       # no feature twice in a row
    for i in range(0, 1003, 97):
        cols = x.indices[x.indptr[i]:x.indptr[i + 1]]
        assert torch.equal(cols, torch.sort(cols).values)
    norms = dense.double().square().sum(1).sqrt()
    torch.testing.assert_close(norms, torch.ones_like(norms), rtol=0, atol=1e-6)
    assert (x.values > 0).all() and x.values.std() > 0.05           # not constant within a row
    assert set(y.unique().tolist()) <= {0.0, 1.0}
    again = _data()[2]
    assert all(torch.equal(again[k], v) for k, v in _data()[2].items() if k != "n_features")


def test_a_slice_is_rows_with_pointers_rebased_and_views_of_the_rest():
    x, _, _ = _data()
    part = x[100:350]
    assert part.shape == (250, 2011)
    assert int(part.indptr[0]) == 0 and int(part.indptr[-1]) == part.nnz
    assert part.indices.data_ptr() == x.indices[int(x.indptr[100]):].data_ptr()
    assert torch.equal(_dense(part), _dense(x)[100:350])
    assert torch.equal(_dense(part[10:20]), _dense(x)[110:120])
    assert x[5:5].shape == (0, 2011) and x[5:5].nnz == 0
    with pytest.raises(TypeError, match="contiguous"):
        x[::2]


@pytest.mark.parametrize("rows", [1003, 3])
def test_host_split_gives_each_thread_its_rows_and_labels(rows):
    """The remainder of the rows goes to the low tids, as for a dense array;
    with 3 rows over 4 threads the last thread's slice is empty."""
    x, y, _ = _data(rows=rows, nnz=29 * rows + 1)
    dense = _dense(x)
    out = Session(backend="host", n_nodes=2, threads_per_node=2, device=CPU).run(
        lambda ctx, xs, ys: (ctx.tid, _dense(xs), ys.clone()), data=(x, y))
    for tid, xs, ys in out:
        lo, hi = partition_rows(rows, tid, 4)
        assert torch.equal(xs, dense[lo:hi]) and torch.equal(ys, y[lo:hi])
    if rows == 3:
        assert out[3][1].shape == (0, x.shape[1])


def test_spmd_split_is_even_and_drops_the_ragged_rows_with_a_warning():
    from repro_torch.core import SpmdBackend, make_mesh
    x, y, _ = _data(rows=1003)
    dense = _dense(x)
    sess = Session(backend=SpmdBackend(mesh=make_mesh((4,), ("data",), CPU)), device=CPU)
    with pytest.warns(UserWarning, match="dropping 6 ragged row"):
        out = sess.run(lambda ctx, xs, ys: (ctx.tid, _dense(xs), ys.clone()), data=(x, y))
    for tid, xs, ys in out:
        lo, hi = 250 * tid, 250 * (tid + 1)
        assert torch.equal(xs, dense[lo:hi]) and torch.equal(ys, y[lo:hi])


# -- fit over a CSR x on the CPU ------------------------------------------------


ITERS = 6


def _lr(y):
    return 1.0 / y.shape[0]       # step 1 on the mean log-loss, as the cell runs it


@pytest.mark.parametrize("mode", ["auto", "reduce_scatter", "sparse"])
def test_fit_matches_the_benchmark_reference(mode):
    """Held to the fp64 reference at 2e-6 of max |theta|: the port's
    theta and residuals are fp32 (a rounding of 6e-8 a round, over 6 rounds,
    and the accumulator's fp32 sum of four threads' gradients), its
    gradient sums fp64 as the reference's.  SPARSE at a budget of every
    feature is lossless."""
    x, y, d = _data()
    k = x.shape[1] if mode == "sparse" else None
    got, _ = logreg.fit(x, y, iters=ITERS, lr=_lr(y), mode=mode, k=k, device=CPU)
    want = ref.theta(d["indptr"], d["indices"], d["values"], d["n_features"], y, ITERS, _lr(y))
    assert ref.theta_gap(got, want) < 2e-6


def test_plain_path_matches_the_dense_fit_on_the_same_matrix():
    """The CSR path and the dense path on x densified: 1e-5 of max |theta|
    (the dense path's products and sums are fp32 in another order)."""
    x, y, _ = _data()
    got, _ = logreg.fit(x, y, iters=ITERS, lr=_lr(y), device=CPU)
    dense, _ = logreg.fit(_dense(x).numpy(), y.numpy(), iters=ITERS, lr=_lr(y), device=CPU)
    assert np.abs(got - dense).max() < 1e-5 * np.abs(dense).max()


def test_mean_loss_falls_every_iteration():
    x, y, _ = _data(seed=9)
    dense = _dense(x).numpy()
    losses = [logreg.loss(logreg.fit(x, y, iters=i, lr=_lr(y), device=CPU)[0], dense, y.numpy())
              for i in range(ITERS + 1)]
    assert all(b < a for a, b in zip(losses, losses[1:])), losses


@pytest.mark.parametrize("backend", ["host", "spmd"])
def test_cpu_fit_counts_the_plain_path_and_the_nonzeros(backend, monkeypatch):
    """A traced CPU job calls the plain ``_csr_grad`` threads x iters times,
    on slices whose nonzeros add up to all of them, launches no kernel, and
    records the job's spans; its theta is the untraced job's to 1e-6 of max
    |theta|."""
    from repro_torch.core import SpmdBackend, make_mesh
    x, y, _ = _data(rows=1000, nnz=29_400)
    calls = _counting(monkeypatch, logreg, "_csr_grad")
    build.reset_launches()
    if backend == "host":
        sess = Session(backend="host", n_nodes=2, threads_per_node=2, trace=True, device=CPU)
    else:
        sess = Session(backend=SpmdBackend(mesh=make_mesh((4,), ("data",), CPU)), trace=True,
                       device=CPU)
    try:
        got, _ = logreg.fit(x, y, iters=ITERS, lr=_lr(y), session=sess)
        jobs = [e["name"] for e in sess.tracer.spans() if e.get("cat") == "job"]
    finally:
        sess.tracer.disable()
    assert len(calls) == 4 * ITERS
    slices = {id(c[1]): c[1] for c in calls}
    assert len(slices) == 4 and sum(xs.nnz for xs in slices.values()) == 29_400
    assert not any(build.launch_counts().values())
    assert sorted(jobs) == ["job.setup", "job.teardown", "session.join", "session.spawn"]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want, _ = logreg.fit(x, y, iters=ITERS, lr=_lr(y), backend=backend, device=CPU,
                             **({"mesh": make_mesh((4,), ("data",), CPU)}
                                if backend == "spmd" else {}))
    # the dense round adds the threads' fp32 gradients in their arrival order
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
    assert telemetry.armed_count() == 0


def test_dense_fit_records_no_job_span_and_no_sparse_counter(monkeypatch):
    """A dense x keeps the JAX package's spans and counters, and its path:
    the dense gradient a thread and round, never the CSR one."""
    x, y, _ = _data()
    sparse = _counting(monkeypatch, logreg, "_csr_grad")
    dense = _counting(monkeypatch, logreg, "_local_grad")
    sess = Session(backend="host", n_nodes=2, threads_per_node=2, trace=True, device=CPU)
    try:
        logreg.fit(_dense(x).numpy(), y.numpy(), iters=2, session=sess)
        counters = sess.tracer.counters()
        cats = {e.get("cat") for e in sess.tracer.spans()}
    finally:
        sess.tracer.disable()
    assert "job" not in cats
    assert not any(k.startswith("logreg.") for k in counters)
    assert not sparse and len(dense) == 4 * 2


def test_margin_plain_by_hand():
    """Two rows: z = 0.5 * 2 + 0.25 * -4 = 0, and z = 1 * 1 = 1."""
    x = CSRMatrix(torch.tensor([0, 2, 3]), torch.tensor([0, 2, 1], dtype=torch.int32),
                  torch.tensor([0.5, 0.25, 1.0]), 3)
    theta = torch.tensor([2.0, 1.0, -4.0])
    y = torch.tensor([1.0, 0.0])
    r = margin_residuals_plain(x, y, theta)
    torch.testing.assert_close(r, torch.tensor([0.5, -1 / (1 + np.exp(-1.0))],
                                               dtype=torch.float32))


BAD_MARGIN = {
    "theta_short": lambda x, y, t: (x, y, t[:-1]),
    "theta_f64": lambda x, y, t: (x, y, t.double()),
    "y_short": lambda x, y, t: (x, y[:-1], t),
    "theta_strided": lambda x, y, t: (x, y, torch.zeros(2 * t.numel())[::2]),
    "on_the_cpu": lambda x, y, t: (x, y, t),
}


@pytest.mark.parametrize("case", sorted(BAD_MARGIN))
def test_margin_residuals_refuses_what_it_does_not_take(case):
    """Checked before any launch; a CPU matrix is refused even where the
    rest is right (the CPU takes the plain version)."""
    x, y, _ = _data(rows=50, nnz=1470)
    with pytest.raises((TypeError, ValueError)) as err:
        margin_residuals(*BAD_MARGIN[case](x, y, torch.zeros(x.shape[1])))
    if case == "on_the_cpu":
        assert "card" in str(err.value)


def test_bin_edges_refuses_values_it_does_not_take():
    edges = torch.zeros((8, 2), dtype=torch.int32)
    with pytest.raises(TypeError, match="values"):
        bin_edges(edges, 50, values=torch.ones(7))
    with pytest.raises(ValueError, match="n_sources"):
        bin_edges(edges, 50, values=torch.ones(8), n_sources=-1)


# -- on the card -------------------------------------------------------------------


def _counting(monkeypatch, module, name: str) -> list:
    """Replace ``module.name`` by a wrapper that records each call's
    arguments; returns the record."""
    calls, fn = [], getattr(module, name)

    def counted(*args):
        calls.append(args)
        return fn(*args)

    monkeypatch.setattr(module, name, counted)
    return calls


def _plain_grad(x: CSRMatrix, r: torch.Tensor):
    """The fp64 sum by feature of r[row] * value, and of its terms' size."""
    rows, cols = x.row_ids(), x.indices.long()
    terms = r[rows].double() * x.values.double()
    g = torch.zeros(x.shape[1], dtype=torch.float64, device=r.device).index_add_(0, cols, terms)
    size = torch.zeros_like(g).index_add_(0, cols, terms.abs())
    return g, size


def _held_to_plain(got: torch.Tensor, want64: torch.Tensor, size: torch.Tensor) -> None:
    """Within one fp32 ulp of the fp64 sum, beside the fp64 sums' own
    rounding in another order (a few fp64 eps of the terms' sum)."""
    err = (got.double() - want64).abs()
    assert bool((err <= ULP * want64.abs() + 64 * F64_EPS * size).all()), float(err.max())


# the cell's slice: a quarter of kdd2010 (bridge)'s rows and nonzeros, all its features
SLICE = {"rows": 19_264_097 // 4, "features": 29_890_095, "nnz": 566_345_888 // 4}
SHAPES = {"small": {"rows": 20_011, "features": 70_001, "nnz": 588_335},
          "two_pass": {"rows": 40_000, "features": 2_000_003, "nnz": 1_200_000},
          "cell_slice": SLICE}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_margin_kernel_matches_plain(cuda, shape):
    """The kernel's residuals against the plain version on the card: the
    fp64 row sums round to the same fp32 margin or one ulp apart, and the
    two sigmoids differ by a few fp32 ulps; 2e-6 of residuals in (-1, 1).
    Two calls give the same bits (the adds' order is the row's)."""
    x, y, _ = _data(**SHAPES[shape], seed=3, device=cuda)
    theta = torch.randn(x.shape[1], generator=torch.Generator(device=cuda).manual_seed(1),
                        device=cuda)
    margin_ops.launches.reset()
    got = margin_residuals(x, y, theta)
    want = margin_residuals_plain(x, y, theta)
    torch.testing.assert_close(got, want, rtol=0, atol=2e-6)
    assert torch.equal(margin_residuals(x, y, theta), got)
    assert margin_ops.launches.count == 2
    part = x[x.shape[0] // 3: 2 * x.shape[0] // 3]           # a thread's slice
    torch.testing.assert_close(margin_residuals(part, y[x.shape[0] // 3: 2 * x.shape[0] // 3],
                                                theta), got[x.shape[0] // 3: 2 * x.shape[0] // 3],
                               rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("segment", ["whole", "odd"])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_binned_kernel_with_values_matches_a_plain_fp64_scatter(cuda, shape, segment,
                                                                monkeypatch):
    """A thread's nonzeros binned by feature with their values: the copy
    keeps each (row, feature, value) together, and the round's gradient
    is the plain fp64 sum of r[row] * value rounded once, over two launches
    (the split bins' scratch is reset)."""
    if segment == "odd":
        monkeypatch.setattr(ops, "SEGMENT", 100_003)
    part, _, _ = _data(**SHAPES[shape], seed=4, device=cuda)
    pairs = torch.stack([part.row_ids(torch.int32), part.indices], 1)
    binned = bin_edges(pairs, part.shape[1], values=part.values, n_sources=part.shape[0])
    keys = binned.pairs[:, 0].long() * part.shape[1] + binned.pairs[:, 1].long()
    order = torch.argsort(keys)
    want_keys = pairs[:, 0].long() * part.shape[1] + pairs[:, 1].long()
    assert torch.equal(keys[order], want_keys)                # rows are sorted by row, then id
    assert torch.equal(binned.values[order], part.values)
    r = torch.rand(part.shape[0], generator=torch.Generator(device=cuda).manual_seed(2),
                   device=cuda) - 0.5
    want, size = _plain_grad(part, r)
    for _ in range(2):
        got = binned_credits(binned, r)
        torch.cuda.synchronize()
        _held_to_plain(got, want, size)
    assert not binned.acc.any() and not binned.done.any()


@pytest.mark.cuda
def test_binned_credits_checks_w_against_the_sources(cuda):
    x, _, _ = _data(rows=100, nnz=2_940, device=cuda)
    pairs = torch.stack([x.row_ids(torch.int32), x.indices], 1)
    binned = bin_edges(pairs, x.shape[1], values=x.values, n_sources=x.shape[0])
    with pytest.raises(TypeError, match=r"\(100,\)"):
        binned_credits(binned, torch.zeros(x.shape[1], device=cuda))
    with pytest.raises(ValueError, match="outside"):
        bin_edges(pairs, x.shape[1], values=x.values, n_sources=x.shape[0] - 1)


@pytest.mark.cuda
def test_traced_job_on_the_card_takes_the_binned_path(cuda, monkeypatch):
    """A traced 4-thread job never calls the plain ``_csr_grad``; the
    set-up's histogram and scatter launch once a thread (123 bins: one
    pass), the margin and the binned kernel once a thread and round; the
    slices, binned as the job bins them, split the popular feature's bin;
    theta is the CPU's to 1e-6 of max |theta|."""
    x, y, _ = _data(rows=20_000, features=1_000_003, nnz=588_000, device=cuda)
    calls = _counting(monkeypatch, logreg, "_csr_grad")
    build.reset_launches()
    sess = Session(backend="host", n_nodes=2, threads_per_node=2, trace=True, device=cuda)
    try:
        got, _ = logreg.fit(x, y, iters=5, lr=_lr(y), session=sess)
    finally:
        sess.tracer.disable()
    launched = build.launch_counts()
    assert not calls
    assert [launched[name] for name in ("pagerank_bin_histogram", "pagerank_bin_scatter",
                                        "pagerank_credits", "logreg_margin")] == [4, 4, 20, 20]
    split = 0
    for tid in range(4):
        part = x[slice(*partition_rows(x.shape[0], tid, 4))]
        split += bin_edges(torch.stack([part.row_ids(torch.int32), part.indices], 1),
                           x.shape[1], values=part.values,
                           n_sources=part.shape[0]).plan.n_split
    # the most popular feature alone (1/H(V) = 6.9% of a slice's 147,000
    # nonzeros) is over twice the unit (the floor, 2,048): its bin splits
    assert split >= 4
    cpu_x = x.to(CPU)
    want, _ = logreg.fit(cpu_x, y.cpu(), iters=5, lr=_lr(y), device=CPU)
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
    assert telemetry.armed_count() == 0
