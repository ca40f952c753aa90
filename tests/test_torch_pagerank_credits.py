"""PageRank's binned credit path: the bin plan, the set-up pass and the
round, against the plain ``_credits`` it replaces on the card.

CPU tests hold the plan's split decision on given histograms, the wrappers'
checks (a CPU tensor is refused: the CPU takes ``_credits``) and the CPU
path of ``pagerank.fit``.  Tests marked ``cuda`` hold the kernels against
``_credits`` on the card; they skip elsewhere.  The
module imports nothing of JAX, so ``pytest -m cuda`` runs it on a GPU
machine.
"""

import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from repro_torch.analytics import pagerank  # noqa: E402
from repro_torch.core import Session, telemetry  # noqa: E402
from repro_torch.data import partition_rows, powerlaw_graph  # noqa: E402
from repro_torch.device import to_tensor  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.pagerank_credits import ops  # noqa: E402
from repro_torch.kernels.pagerank_credits.ops import (  # noqa: E402
    BIN, BIN_SHIFT, PIECE_FLOOR, bin_edges, bin_plan, binned_credits)
from stepbench.generators import kronecker  # noqa: E402

CPU = torch.device("cpu")
ULP = torch.finfo(torch.float32).eps     # one fp32 ulp, relative
APP_TOL = dict(rtol=1e-5, atol=1e-6)


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


# -- the plan, from a given histogram ------------------------------------------


def _unit(counts) -> int:
    return max(-(-int(np.sum(counts)) // len(counts)), PIECE_FLOOR)


HISTOGRAMS = {
    "uniform": [5000] * 64,
    "one_hub": [100] * 63 + [500_000],
    "two_hubs": [3000] * 30 + [90_000, 3000, 250_000],
    "mean_below_floor": [1] * 40 + [2 * PIECE_FLOOR, 2 * PIECE_FLOOR + 1],
    "empty": [0] * 9,
    "one_bin": [12345],
}
SPLIT = {"uniform": {}, "one_hub": {63: -(-500_000 // _unit(HISTOGRAMS["one_hub"]))},
         "two_hubs": {30: -(-90_000 // _unit(HISTOGRAMS["two_hubs"])),
                      32: -(-250_000 // _unit(HISTOGRAMS["two_hubs"]))},
         "mean_below_floor": {41: 3}, "empty": {}, "one_bin": {}}


@pytest.mark.parametrize("name", sorted(HISTOGRAMS))
def test_bin_plan_splits_only_bins_far_above_the_mean(name):
    """A bin above twice the unit (the mean, or the floor of one CTA sweep)
    is cut into ceil(count / unit) near-equal pieces sharing one scratch
    slot; the items cover every edge once, each inside its bin, none above
    twice the unit, largest first."""
    counts = np.array(HISTOGRAMS[name], dtype=np.int64)
    plan = bin_plan(counts)
    unit = _unit(counts)
    starts = np.concatenate([[0], np.cumsum(counts)])
    assert np.array_equal(plan.starts, starts)
    items = plan.items
    begin, end, bins, slots = items.T
    sizes = end - begin
    assert (np.diff(sizes) <= 0).all()                     # largest first
    assert (sizes <= 2 * unit).all()
    assert ((begin >= starts[bins]) & (end <= starts[bins + 1])).all()
    covered = np.zeros(int(starts[-1]), dtype=np.int64)
    for b, e in zip(begin, end):
        covered[b:e] += 1
    assert (covered == 1).all()
    split = {int(b): int((bins == b).sum()) for b in np.unique(bins[slots >= 0])}
    assert split == SPLIT[name]
    assert plan.n_split == len(split) == plan.pieces.size
    assert sorted(set(bins.tolist())) == list(range(counts.size))   # every bin written
    for b, k in split.items():
        mine = items[bins == b]
        assert len(set(mine[:, 3].tolist())) == 1 and plan.pieces[mine[0, 3]] == k
        assert np.ptp(mine[:, 1] - mine[:, 0]) <= 1              # near-equal pieces
    assert sorted(set(slots[slots >= 0].tolist())) == list(range(plan.n_split))
    assert ((slots == -1) == np.isin(bins, list(split), invert=True)).all()


@pytest.mark.parametrize("counts", [[], [[1, 2]], [3, -1]])
def test_bin_plan_rejects_what_is_no_histogram(counts):
    with pytest.raises(ValueError, match="histogram"):
        bin_plan(counts)


# -- the wrapper's checks ------------------------------------------------------


def _edges(n: int = 64, v: int = 50, dtype=torch.int32) -> torch.Tensor:
    g = torch.Generator().manual_seed(0)
    return torch.randint(0, v, (n, 2), generator=g).to(dtype)


BAD_EDGES = {
    "v_at_2_31": (lambda: _edges(), 2**31, ValueError, "n_vertices"),
    "v_zero": (lambda: _edges(), 0, ValueError, "n_vertices"),
    "float_edges": (lambda: _edges().float(), 50, TypeError, "int32 or int64"),
    "int16_edges": (lambda: _edges().to(torch.int16), 50, TypeError, "int32 or int64"),
    "strided_rows": (lambda: _edges(128)[::2], 50, ValueError, "contiguous"),
    "column_major": (lambda: _edges().t().contiguous().t(), 50, ValueError, "contiguous"),
    "three_columns": (lambda: torch.zeros((8, 3), dtype=torch.int32), 50, ValueError, r"\(E, 2\)"),
    "on_the_cpu": (lambda: _edges(), 50, ValueError, "card"),
}


@pytest.mark.parametrize("case", sorted(BAD_EDGES))
def test_bin_edges_raises_on_what_it_does_not_take(case):
    make, v, err, match = BAD_EDGES[case]
    with pytest.raises(err, match=match):
        bin_edges(make(), v)


OUT_OF_RANGE = {
    "dst_at_v": lambda: torch.tensor([[0, 1], [2, 50]], dtype=torch.int32),
    "negative_src": lambda: torch.tensor([[-1, 1]], dtype=torch.int64),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(OUT_OF_RANGE))
def test_bin_edges_raises_on_an_index_outside_the_graph(cuda, case):
    """The set-up pass's histogram counts the edges it cannot bin."""
    with pytest.raises(ValueError, match="outside"):
        bin_edges(OUT_OF_RANGE[case]().to(cuda), 50)


BAD_W = {
    "float64": lambda v: torch.ones(v, dtype=torch.float64),
    "short": lambda v: torch.ones(v - 1),
    "two_d": lambda v: torch.ones(v, 1),
    "strided": lambda v: torch.ones(2 * v)[::2],
    "on_the_cpu": lambda v: torch.ones(v),
}


@pytest.mark.parametrize("case", sorted(BAD_W))
def test_binned_credits_raises_on_what_it_does_not_take(case):
    """Checked before any launch: binned edges held where ``w`` is (here
    the CPU, which no launch takes)."""
    plan = bin_plan([64])
    binned = ops._binned(_edges(), 50, plan, torch.from_numpy(plan.items),
                         torch.from_numpy(plan.pieces))
    with pytest.raises((TypeError, ValueError)):
        binned_credits(binned, BAD_W[case](50))


# -- graphs for the binning and the credits -------------------------------------


def _kronecker(scale: int, device) -> tuple:
    cfg = {"graph": {"scale": scale, "edgefactor": 16,
                     "initiator": [0.57, 0.19, 0.19, 0.05], "permute_labels": True}}
    g = kronecker.make(cfg, torch.Generator(device=device).manual_seed(7), device)
    return g["edges"], g["n_vertices"]


def _degenerate(device) -> tuple:
    """Vertices with no out-edges, self-loops and duplicate edges; V not a
    multiple of the bin."""
    v = 3 * BIN + 17
    rng = np.random.default_rng(5)
    src = rng.integers(0, v // 2, size=40_000)            # the upper half sends little
    dst = rng.integers(0, v, size=40_000)
    loops = np.arange(0, v, 97)
    e = np.concatenate([np.stack([src, dst], 1), np.stack([loops, loops], 1),
                        np.repeat([[3, v - 1], [v - 1, 5]], 500, axis=0)])
    return torch.from_numpy(e.astype(np.int32)).to(device), v


GRAPHS = {
    "kronecker16": lambda d: _kronecker(16, d),
    "powerlaw_hub": lambda d: (torch.from_numpy(powerlaw_graph(200_000, 14, seed=1)).to(d),
                               200_000),
    "degenerate": _degenerate,
    "ragged_v": lambda d: (torch.from_numpy(powerlaw_graph(5 * BIN + 3, 6, seed=2)).to(d),
                           5 * BIN + 3),
    "empty": lambda d: (torch.zeros((0, 2), dtype=torch.int32, device=d), 1000),
    "int64": lambda d: (torch.from_numpy(powerlaw_graph(30_000, 8, seed=4)).long().to(d),
                        30_000),
    "kronecker20": lambda d: _kronecker(20, d),
    # more bins than a bucket holds: the scatter's two passes, from int32 and int64
    "two_pass": lambda d: (torch.from_numpy(powerlaw_graph(3_000_017, 4, seed=8)).to(d),
                           3_000_017),
    "two_pass_int64": lambda d: (torch.from_numpy(powerlaw_graph(2_097_155, 2, seed=9))
                                 .long().to(d), 2_097_155),
    "many_bins": lambda d: _many_bins(d),
}


def _many_bins(device) -> tuple:
    """More bins than the set-up pass counts in shared memory (V > 2^27):
    its global-atomic paths."""
    v = (1 << 27) + 5
    g = torch.Generator().manual_seed(10)
    return torch.randint(0, v, (1 << 20, 2), generator=g, dtype=torch.int64).int().to(device), v


def _slice(edges: torch.Tensor, tid: int = 1, n: int = 4) -> torch.Tensor:
    """One thread's row slice, as the host backend hands it out."""
    lo, hi = edges.shape[0] * tid // n, edges.shape[0] * (tid + 1) // n
    return edges[lo:hi]


def _counting(monkeypatch, module, name: str) -> list:
    """Replace ``module.name`` by a wrapper that records each call's
    arguments; returns the record."""
    calls, fn = [], getattr(module, name)

    def counted(*args):
        calls.append(args)
        return fn(*args)

    monkeypatch.setattr(module, name, counted)
    return calls


def _keys(pairs: torch.Tensor, v: int) -> torch.Tensor:
    return torch.sort(pairs[:, 0].long() * v + pairs[:, 1].long()).values


def _check_binned(binned, edges: torch.Tensor, v: int) -> None:
    """The copy is int32, a permutation of the slice's rows, grouped by bin
    at the plan's starts."""
    pairs = binned.pairs
    assert pairs.dtype == torch.int32 and pairs.shape == edges.shape
    assert torch.equal(_keys(pairs, v), _keys(edges, v))
    bins = (pairs[:, 1].long() >> BIN_SHIFT).cpu()
    starts = torch.from_numpy(binned.plan.starts)
    assert starts.numel() == -(-v // BIN) + 1
    assert torch.equal(torch.bincount(bins, minlength=starts.numel() - 1),
                       torch.diff(starts))
    assert (torch.diff(bins) >= 0).all()


def _inputs(edges: torch.Tensor, v: int, seed: int = 3):
    """Ranks (positive, not uniform) and the whole graph's out-degrees."""
    g = torch.Generator().manual_seed(seed)
    ranks = (torch.rand(v, generator=g) + 0.5) / v
    deg = pagerank._out_degree(edges[:, 0].long().cpu(), v)
    return ranks.to(edges.device), deg.to(edges.device)


def test_powerlaw_hub_splits_its_bin():
    """powerlaw_graph puts ~44% of the edges on one vertex: the plan of a
    thread's slice, from its histogram, splits that bin."""
    edges, v = GRAPHS["powerlaw_hub"](CPU)
    dst = _slice(edges)[:, 1].long()
    plan = bin_plan(torch.bincount(dst >> BIN_SHIFT, minlength=-(-v // BIN)).numpy())
    hub = int(np.argmax(np.diff(plan.starts)))
    assert plan.n_split >= 1 and (plan.items[:, 2] == hub).sum() > 1


# -- the CPU path of pagerank.fit ------------------------------------------------


@pytest.mark.parametrize("mode", ["auto", "sparse", "reduce_scatter"])
def test_cpu_fit_takes_the_plain_path_once_per_thread_round(mode, monkeypatch):
    """A traced CPU job calls the plain ``_credits`` threads x iters times
    and launches no kernel; its ranks are the untraced job's."""
    edges = powerlaw_graph(300, 5, seed=3)
    k = 20 if mode == "sparse" else None
    calls = _counting(monkeypatch, pagerank, "_credits")
    build.reset_launches()
    sess = Session(backend="host", n_nodes=2, threads_per_node=2, trace=True, device=CPU)
    try:
        got, _ = pagerank.fit(edges, 300, iters=6, mode=mode, k=k, session=sess)
    finally:
        sess.tracer.disable()
    assert len(calls) == 4 * 6
    assert not any(build.launch_counts().values())
    want, _ = pagerank.fit(edges, 300, iters=6, mode=mode, k=k, device=CPU)
    np.testing.assert_allclose(got, want, **APP_TOL)


# -- on the card -----------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("segment", ["whole", "odd"])
@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_binned_credits_kernel_matches_plain_credits(cuda, graph, segment, monkeypatch):
    """The set-up pass gives a permutation of the slice grouped by bin and
    leaves the slice as it was, whole or in segments of an odd size; the
    round's credits are the plain fp64 ``_credits`` rounded once, to one
    fp32 ulp (the fp64 adds run in another order), over two launches (the
    split bins' scratch is reset)."""
    if segment == "odd":
        monkeypatch.setattr(ops, "SEGMENT", 100_003)
    edges, v = GRAPHS[graph](cuda)
    part = _slice(edges)
    before = part.clone()
    binned = bin_edges(part, v)
    torch.cuda.synchronize()
    assert torch.equal(part, before)
    _check_binned(binned, part, v)
    ranks, deg = _inputs(edges, v)
    want = pagerank._credits(part[:, 0].long(), part[:, 1].long(), ranks, deg, v)
    for _ in range(2):
        got = binned_credits(binned, ranks / deg)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=ULP, atol=0.0)
        assert torch.equal(got == 0, want == 0)
    assert not binned.acc.any() and not binned.done.any()
    if graph == "powerlaw_hub":
        assert binned.plan.n_split >= 1


@pytest.mark.cuda
def test_traced_job_on_the_card_takes_the_binned_path(cuda, monkeypatch):
    """A traced 4-thread job never calls the plain ``_credits``; the
    set-up's histogram and scatter launch once a thread (25 bins: one
    segment, one scatter pass), the round's kernel once a thread and round;
    the hub's bin splits in each thread's slice; the ranks are the CPU
    oracle's to the app tolerance."""
    edges = powerlaw_graph(200_000, 8, seed=6)
    calls = _counting(monkeypatch, pagerank, "_credits")
    build.reset_launches()
    sess = Session(backend="host", n_nodes=2, threads_per_node=2, trace=True, device=cuda)
    try:
        got, _ = pagerank.fit(edges, 200_000, iters=5, session=sess)
    finally:
        sess.tracer.disable()
    launched = build.launch_counts()
    assert not calls
    assert [launched[name] for name in ("pagerank_bin_histogram", "pagerank_bin_scatter",
                                        "pagerank_credits")] == [4, 4, 4 * 5]
    e = to_tensor(edges, cuda)                               # as fit holds them
    split = sum(bin_edges(e[slice(*partition_rows(e.shape[0], tid, 4))], 200_000).plan.n_split
                for tid in range(4))
    assert split >= 4                                        # the hub's bin, in each slice
    np.testing.assert_allclose(got, pagerank.fit_reference(edges, 200_000, 5, device=CPU),
                               **APP_TOL)
    assert telemetry.armed_count() == 0


@pytest.mark.cuda
def test_a_round_holds_no_edge_sized_temporary(cuda):
    """Mid-size (SCALE 20, 16.8 M edges): a thread's round allocates its w
    and its credits, nothing E-sized; the whole job allocates less than the
    int64 copies of src and dst that the plain path held (16 B an edge):
    the out-degree's transient int64 column and ones (12 B), then the
    binned int32 copies (8 B) and V-sized vectors."""
    edges, v = _kronecker(20, cuda)
    n = edges.shape[0]
    binned = bin_edges(_slice(edges), v)
    ranks, deg = _inputs(edges, v)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(3):
        binned_credits(binned, ranks / deg)
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated() - held <= 3 * 4 * v + (1 << 20)
    del binned
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    pagerank.fit(edges, v, iters=3, device=cuda)
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated() - held < 16 * n
