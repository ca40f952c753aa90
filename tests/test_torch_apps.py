"""The port's analytics apps against repro's fit(backend="host") and both
packages' fit_reference, on the same numpy data, with equal wire traffic.

Whole runs compare to rtol=1e-5, atol=1e-6: the host accumulator sums a
dense round in arrival order, so runs agree to a tolerance, not to the bit.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.analytics import kmeans as jkmeans  # noqa: E402
from repro.analytics import logreg as jlogreg  # noqa: E402
from repro.analytics import nmf as jnmf  # noqa: E402
from repro.analytics import pagerank as jpagerank  # noqa: E402
from repro.core.session import HostBackend as JHost  # noqa: E402
from repro.core.session import Session as JSession  # noqa: E402
from repro.data import kmeans_dataset as j_kmeans_dataset  # noqa: E402
from repro.data import logreg_dataset as j_logreg_dataset  # noqa: E402
from repro.data import nmf_dataset as j_nmf_dataset  # noqa: E402
from repro.data import powerlaw_graph as j_powerlaw_graph  # noqa: E402
from repro_torch.analytics import kmeans, logreg, nmf, pagerank  # noqa: E402
from repro_torch.core import HostBackend, Session  # noqa: E402
from repro_torch.data import (  # noqa: E402
    kmeans_dataset, logreg_dataset, nmf_dataset, powerlaw_graph)
from repro_torch.kernels import build  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs files in parallel workers, and
    torch's default of one thread per core would oversubscribe the CPU
    under the timing-sensitive tests of other files."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


APP_TOL = dict(rtol=1e-5, atol=1e-6)


def test_datasets_identical_from_one_seed():
    for a, b in ((powerlaw_graph(300, 5, seed=3), j_powerlaw_graph(300, 5, seed=3)),
                 (kmeans_dataset(100, 8, 4, seed=1)[0], j_kmeans_dataset(100, 8, 4, seed=1)[0]),
                 (logreg_dataset(100, 16, seed=2)[0], j_logreg_dataset(100, 16, seed=2)[0]),
                 (logreg_dataset(100, 16, seed=2)[1], j_logreg_dataset(100, 16, seed=2)[1]),
                 (nmf_dataset(60, 20, 3, seed=4)[0], j_nmf_dataset(60, 20, 3, seed=4)[0])):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("degree,branch", [(5, "sparse"), (40, "reduce_scatter")])
def test_pagerank_auto_matches_repro(degree, branch):
    """AUTO on a graph where the pairs branch wins and one where dense wins."""
    edges = powerlaw_graph(300, degree, seed=3)
    r_t, s_t = pagerank.fit(edges, 300, iters=10, device="cpu")
    r_j, s_j = jpagerank.fit(edges, 300, iters=10, backend="host")
    np.testing.assert_allclose(r_t, r_j, **APP_TOL)
    np.testing.assert_allclose(r_t, pagerank.fit_reference(edges, 300, 10, device="cpu"),
                               **APP_TOL)
    np.testing.assert_allclose(r_t, jpagerank.fit_reference(edges, 300, 10), **APP_TOL)
    assert s_t.wire_traffic() == s_j.wire_traffic()
    assert s_t.accumulator("credits").last_mode.value == branch
    assert s_j.accumulator("credits").last_mode.value == branch


@pytest.mark.parametrize("fused", [True, False])
def test_pagerank_sparse_lossy_matches_repro(fused):
    edges = powerlaw_graph(300, 5, seed=4)
    r_t, s_t = pagerank.fit(edges, 300, iters=8, mode="sparse", k=20,
                            session=Session(backend=HostBackend(fused=fused), device="cpu"))
    r_j, s_j = jpagerank.fit(edges, 300, iters=8, mode="sparse", k=20,
                             session=JSession(backend=JHost(fused=fused)))
    np.testing.assert_allclose(r_t, r_j, **APP_TOL)
    assert s_t.wire_traffic() == s_j.wire_traffic()


@pytest.mark.parametrize("fused", [True, False])
def test_logreg_sparse_k_matches_repro(fused):
    x, y, _ = logreg_dataset(400, 64, seed=0)
    th_t, s_t = logreg.fit(x, y, iters=8, mode="sparse", k=16,
                           session=Session(backend=HostBackend(fused=fused), device="cpu"))
    th_j, s_j = jlogreg.fit(x, y, iters=8, mode="sparse", k=16,
                            session=JSession(backend=JHost(fused=fused)))
    np.testing.assert_allclose(th_t, th_j, **APP_TOL)
    assert s_t.wire_traffic() == s_j.wire_traffic()
    assert s_t.accumulator("grad").last_pair_counts == s_j.accumulator("grad").last_pair_counts


def test_logreg_dense_matches_references():
    x, y, _ = logreg_dataset(400, 24, seed=0)
    th_t, s_t = logreg.fit(x, y, iters=10, device="cpu")
    th_j, s_j = jlogreg.fit(x, y, iters=10, backend="host")
    np.testing.assert_allclose(th_t, th_j, **APP_TOL)
    ref = logreg.fit_reference(x, y, 10, device="cpu")
    np.testing.assert_allclose(ref, jlogreg.fit_reference(x, y, 10), **APP_TOL)
    np.testing.assert_allclose(th_t, ref, rtol=1e-4, atol=1e-5)   # threads vs oracle
    assert s_t.wire_traffic() == s_j.wire_traffic() == (4 + 1) * 24 * 10
    assert logreg.loss(th_t, x, y) < logreg.loss(np.zeros(24, np.float32), x, y)


@pytest.mark.parametrize("use_kernel", [True, False])
def test_kmeans_matches_repro(use_kernel):
    x, _, _ = kmeans_dataset(600, 8, 5, seed=1)
    build.reset_launches()
    c_t, s_t = kmeans.fit(x, 5, iters=6, seed=1, use_kernel=use_kernel, device="cpu")
    c_j, s_j = jkmeans.fit(x, 5, iters=6, seed=1, use_kernel=use_kernel, backend="host")
    np.testing.assert_allclose(c_t, c_j, **APP_TOL)
    np.testing.assert_allclose(c_t, kmeans.fit_reference(x, 5, 6, 1, device="cpu"),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(c_t, jkmeans.fit_reference(x, 5, 6, 1), rtol=1e-4, atol=1e-5)
    assert s_t.wire_traffic() == s_j.wire_traffic()
    np.testing.assert_allclose(kmeans.inertia(x, c_t, device="cpu"),
                               jkmeans.inertia(x, c_j), rtol=1e-5)
    assert build.launch_counts()["kmeans_assign"] == 0       # CPU: plain route


def test_logreg_ssp_async_converges():
    x, y, _ = logreg_dataset(400, 16, seed=4)
    ref = logreg.fit_reference(x, y, iters=12, lr=1e-3, device="cpu")
    ssp, clock = logreg.fit_ssp(x, y, n_workers=4, staleness=1, iters=12, lr=1e-3,
                                device="cpu")
    assert logreg.loss(ssp, x, y) < logreg.loss(ref, x, y) * 1.5 + 0.05
    assert clock.min_clock() == 12


# nmf_dataset(seed) and fit(seed) draw P then Q from one stream: the fits
# start from another seed than the data's, or they would start at the answer
NMF_DATA_SEED, NMF_INIT_SEED = 2, 3


def test_nmf_reference_matches_repro():
    r, _, _ = nmf_dataset(120, 32, 4, seed=NMF_DATA_SEED)
    p_t, q_t = nmf.fit_reference(r, 4, iters=10, seed=NMF_INIT_SEED, device="cpu")
    p_j, q_j = jnmf.fit_reference(r, 4, iters=10, seed=NMF_INIT_SEED)
    np.testing.assert_allclose(p_t, p_j, rtol=1e-5)
    np.testing.assert_allclose(q_t, q_j, rtol=1e-5)
    np.testing.assert_allclose(nmf.frob_loss(r, p_t, q_t, device="cpu"),
                               jnmf.frob_loss(r, p_j, q_j), rtol=1e-5)


@pytest.mark.parametrize("mode", ["auto", "reduce_scatter"])
def test_nmf_matches_repro(mode):
    """2 x 2 threads at test_analytics.py's size: the loss within its rtol
    1e-2 of both references, Q to the app tolerance, equal wire traffic and
    branch.  Under auto every round is dense, through ops.accumulate."""
    r, _, _ = nmf_dataset(120, 32, 4, seed=NMF_DATA_SEED)
    p_t, q_t, s_t = nmf.fit(r, 4, iters=10, seed=NMF_INIT_SEED, mode=mode, device="cpu")
    p_j, q_j, s_j = jnmf.fit(r, 4, iters=10, seed=NMF_INIT_SEED, mode=mode, backend="host")
    loss = nmf.frob_loss(r, p_t, q_t, device="cpu")
    np.testing.assert_allclose(loss, jnmf.frob_loss(r, p_j, q_j), rtol=1e-2)
    p_r, q_r = nmf.fit_reference(r, 4, iters=10, seed=NMF_INIT_SEED, device="cpu")
    assert loss < nmf.frob_loss(r, *nmf._init(120, 32, 4, NMF_INIT_SEED), device="cpu")
    np.testing.assert_allclose(loss, nmf.frob_loss(r, p_r, q_r, device="cpu"), rtol=1e-2)
    np.testing.assert_allclose(q_t, q_j, **APP_TOL)
    assert p_t.shape == (120, 4) and q_t.shape == (4, 32)
    assert s_t.wire_traffic() == s_j.wire_traffic() == (4 + 1) * (4 * 32 + 16) * 10
    assert s_t.accumulator("q_partials").last_mode.value == "reduce_scatter"
    assert s_j.accumulator("q_partials").last_mode.value == "reduce_scatter"
