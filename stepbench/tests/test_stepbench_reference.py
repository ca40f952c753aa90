"""The plain references on cases worked by hand, and beside the port at a
small size on the CPU."""

import numpy as np
import pytest
import torch

from stepbench.reference import nmf as ref_nmf
from stepbench.reference import pagerank as ref_pr


def test_pagerank_one_round_by_hand():
    # 0->1, 1->2, 2->0, 0->2, and vertex 3 with no out-edge
    edges = torch.tensor([[0, 1], [1, 2], [2, 0], [0, 2]], dtype=torch.int32)
    assert ref_pr.out_degree(edges, 4).tolist() == [2, 1, 1, 0]
    r = ref_pr.ranks(edges, 4, iters=1, damping=0.85)
    # credits: v0 from 2: 1/4; v1 from 0: 1/8; v2 from 1 and 0: 1/4 + 1/8
    want = 0.15 / 4 + 0.85 * np.array([1 / 4, 1 / 8, 3 / 8, 0.0])
    np.testing.assert_allclose(r.numpy(), want, rtol=1e-15)
    assert ref_pr.rank_gap(want.astype(np.float32), r) < 1e-7
    assert ref_pr.rank_gap(want * (1 + 1e-4), r) == pytest.approx(1e-4)


def test_nmf_one_round_by_hand():
    r = torch.tensor([[1.0, 2.0], [3.0, 4.0], [5.0, 6.0]])
    p0, q0 = ref_nmf.initial(3, 2, 1, seed=7)
    p, q = ref_nmf.factors(r, 1, iters=1, seed=7)
    p0, q0, rn = p0.astype(np.float64), q0.astype(np.float64), r.numpy().astype(np.float64)
    p1 = p0 * (rn @ q0.T) / (p0 @ (q0 @ q0.T) + 1e-9)
    q1 = q0 * (p1.T @ rn) / ((p1.T @ p1) @ q0 + 1e-9)
    np.testing.assert_allclose(p.numpy(), p1, rtol=1e-12)
    np.testing.assert_allclose(q.numpy(), q1, rtol=1e-12)
    assert ref_nmf.gap(q1 * (1 + 1e-3), q) == pytest.approx(1e-3 * q1.max() / q1.max(), rel=1e-6)


def test_nmf_initial_stream_is_the_ports():
    from repro_torch.analytics import nmf
    for got, want in zip(ref_nmf.initial(50, 7, 3, seed=123), nmf._init(50, 7, 3, 123)):
        assert np.array_equal(got, want)


def test_references_agree_with_the_port_on_the_cpu():
    from repro_torch.analytics import nmf, pagerank
    from stepbench.generators import kronecker
    cfg = {"graph": {"scale": 10, "edgefactor": 16, "initiator": [0.57, 0.19, 0.19, 0.05]}}
    g = kronecker.make(cfg, torch.Generator().manual_seed(2), torch.device("cpu"))
    want = ref_pr.ranks(g["edges"], g["n_vertices"], 10, 0.85)
    got = pagerank.fit_reference(g["edges"].numpy(), g["n_vertices"], iters=10, device="cpu")
    assert ref_pr.rank_gap(got, want) < 1e-6
    r = torch.rand(64, 24, generator=torch.Generator().manual_seed(4))
    p, q = ref_nmf.factors(r, 4, 10, seed=9)
    gp, gq = nmf.fit_reference(r.numpy(), 4, iters=10, seed=9, device="cpu")
    assert ref_nmf.gap(gp, p) < 1e-5 and ref_nmf.gap(gq, q) < 1e-5


def test_controls_read_the_lower_precision():
    from stepbench.generators import kronecker
    cfg = {"graph": {"scale": 10, "edgefactor": 16, "initiator": [0.57, 0.19, 0.19, 0.05]}}
    g = kronecker.make(cfg, torch.Generator().manual_seed(2), torch.device("cpu"))
    r32 = ref_pr.ranks(g["edges"], g["n_vertices"], 10, 0.85, torch.float32)
    assert r32.dtype == torch.float32
    assert ref_pr.rank_gap(r32.numpy(), ref_pr.ranks(g["edges"], g["n_vertices"], 10, 0.85)) > 0
    r = torch.rand(64, 24, generator=torch.Generator().manual_seed(4))
    p, q = ref_nmf.factors(r, 4, 2, seed=9, dtype=torch.float32, tf32=True)
    assert p.dtype == q.dtype == torch.float32
    assert torch.backends.cuda.matmul.allow_tf32 is False
