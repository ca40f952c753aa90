"""The benchmark's input generators, at small sizes on the CPU."""

import torch

from stepbench.generators import kronecker, lowrank

SCALE = 12
A, B, C, D = 0.57, 0.19, 0.19, 0.05


def _graph(seed=3, permute=True, scale=SCALE):
    cfg = {"graph": {"scale": scale, "edgefactor": 16, "initiator": [A, B, C, D],
                     "permute_labels": permute}}
    return kronecker.make(cfg, torch.Generator().manual_seed(seed), torch.device("cpu"))


def test_kronecker_edge_count_and_range():
    g = _graph()
    assert g["n_vertices"] == 1 << SCALE
    assert g["edges"].shape == (16 << SCALE, 2)
    assert g["edges"].dtype == torch.int32
    assert int(g["edges"].min()) >= 0 and int(g["edges"].max()) < 1 << SCALE


def test_kronecker_labels_are_permuted():
    plain, permuted = _graph(permute=False), _graph(permute=True)
    # before the permutation vertex 0 (all bits 0) is the top hub
    deg = torch.bincount(plain["edges"][:, 1].long(), minlength=1 << SCALE)
    assert int(deg.argmax()) == 0
    # the permutation relabels: the same degree multiset, other labels
    deg_p = torch.bincount(permuted["edges"][:, 1].long(), minlength=1 << SCALE)
    assert torch.equal(deg.sort().values, deg_p.sort().values)
    assert not torch.equal(deg, deg_p)


def test_kronecker_top_vertex_share_is_the_specs():
    g = _graph(seed=11)
    e = g["edges"].shape[0]
    top = int(torch.bincount(g["edges"][:, 1].long()).max()) / e
    want = (A + C) ** SCALE           # the column of all-zero bits
    assert 0.8 * want < top < 1.25 * want
    assert top < 0.437 / 10           # far from powerlaw_graph's one-vertex 43.7%


def test_kronecker_same_seed_same_graph():
    assert torch.equal(_graph(seed=5)["edges"], _graph(seed=5)["edges"])
    assert not torch.equal(_graph(seed=5)["edges"], _graph(seed=6)["edges"])


def test_lowrank_matrix():
    cfg = {"matrix": {"users": 40_000, "items": 33, "data_rank": 4, "noise": 0.01}}
    r = lowrank.make(cfg, torch.Generator().manual_seed(1), torch.device("cpu"))["r"]
    assert r.shape == (40_000, 33) and r.dtype == torch.float32
    assert float(r.min()) >= 0
    again = lowrank.make(cfg, torch.Generator().manual_seed(1), torch.device("cpu"))["r"]
    assert torch.equal(r, again)
    # rank 4 plus noise 0.01: the fifth singular value is the noise's
    s = torch.linalg.svdvals(r[:2000].double())
    assert float(s[4] / s[0]) < 1e-3
