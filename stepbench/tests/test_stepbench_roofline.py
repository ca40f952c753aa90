"""The frozen roofline counts against the figures worked by hand."""

import pytest

from stepbench import manifest

ROOT = manifest.HERE.parent


def _cfg(name):
    return manifest.load_json(ROOT / "stepbench" / "configs" / f"{name}.json")


def test_pagerank_g500_counts():
    cfg = _cfg("pagerank-g500")
    roof = manifest.module("roofline", "pagerank-g500")
    # 4 B an edge over 2**30 edges, 12 B a vertex over 2**26: 5.100 GB
    assert roof.iteration_least_s(cfg) == pytest.approx(5.100e9 / 3.35e12, rel=1e-3)
    assert roof.iteration_least_s(cfg) * 1e3 == pytest.approx(1.522, abs=1e-3)
    # G: four rows of 2**26 floats read, one written
    g = roof.kernel_least_s(cfg)["accumulate_kernel"]
    assert g == pytest.approx(5 * 2**26 * 4 / 3.35e12)


def test_nmf_netflix_counts():
    cfg = _cfg("nmf-netflix")
    roof = manifest.module("roofline", "nmf-netflix")
    assert roof.iteration_flops(cfg) == pytest.approx(2.193e12, rel=1e-3)
    # at 3xTF32's 165 TFLOP/s, above R read once (34.13 GB, 10.19 ms)
    assert roof.iteration_least_s(cfg) * 1e3 == pytest.approx(13.29, abs=0.01)
    assert 4 * 480_189 * 17_770 / 3.35e12 * 1e3 == pytest.approx(10.19, abs=0.01)
    assert roof.kernel_least_s(cfg) == {}
