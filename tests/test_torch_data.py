"""The port's LM data pipeline against repro's: tests/test_data.py mirrored
(its hypothesis draws replaced by a fixed list), the batches bit-equal to
repro's for the same (seed, step), shard_batch's placement and its check
that the batch splits over the data axes, and Prefetcher.close."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro import data as jdata  # noqa: E402
from repro_torch.core.compat import P, make_mesh, shard_map  # noqa: E402
from repro_torch.data import (  # noqa: E402
    LMDataPipeline, Prefetcher, SyntheticLM, lm_batch, partition_rows, shard_batch)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs files in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- tests/test_data.py ----------------------------------------------------------------


def test_stateless_stream():
    b1 = lm_batch(5, 4, 16, 100, seed=7)
    b2 = lm_batch(5, 4, 16, 100, seed=7)
    assert np.array_equal(b1["tokens"], b2["tokens"])
    b3 = lm_batch(6, 4, 16, 100, seed=7)
    assert not np.array_equal(b1["tokens"], b3["tokens"])


def test_pipeline_restart_exact():
    p = LMDataPipeline(4, 8, 100, prefetch=True, device="cpu")
    batches = [p.next() for _ in range(3)]
    p.close()
    p2 = LMDataPipeline(4, 8, 100, prefetch=False, start_step=1, device="cpu")
    s, b = p2.next()
    assert s == 1
    assert torch.equal(b["tokens"], batches[1][1]["tokens"])


def test_labels_are_shifted_tokens():
    b = lm_batch(0, 2, 8, 50, seed=0)
    assert np.array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])


@pytest.mark.parametrize("n_rows,n_threads", [(1, 1), (1, 16), (7, 3), (100, 16), (500, 7),
                                              (499, 16), (16, 16)])
def test_partition_rows_cover_disjoint(n_rows, n_threads):
    spans = [partition_rows(n_rows, t, n_threads) for t in range(n_threads)]
    covered = []
    for lo, hi in spans:
        assert 0 <= lo <= hi <= n_rows
        covered.extend(range(lo, hi))
    assert covered == list(range(n_rows))
    assert spans == [jdata.partition_rows(n_rows, t, n_threads) for t in range(n_threads)]


# -- the same tokens as repro -----------------------------------------------------------


@pytest.mark.parametrize("seed,step", [(0, 0), (7, 5), (3, 123), (12345, 2)])
def test_lm_batch_bit_equal_repro(seed, step):
    ours, theirs = lm_batch(step, 3, 17, 151_936, seed), jdata.lm_batch(step, 3, 17, 151_936, seed)
    for k in ("tokens", "labels"):
        assert ours[k].dtype == theirs[k].dtype == np.int32
        np.testing.assert_array_equal(ours[k], theirs[k])
    assert SyntheticLM(3, 17, 151_936, seed).batch(step)["tokens"].tobytes() == \
        jdata.SyntheticLM(3, 17, 151_936, seed).batch(step)["tokens"].tobytes()


def test_pipeline_batches_equal_repros():
    """Prefetched steps 2..5 of both pipelines: same steps, same tokens; the
    port's on the device it was asked for, int32."""
    ours = LMDataPipeline(4, 8, 1000, seed=9, start_step=2, device="cpu")
    theirs = jdata.LMDataPipeline(4, 8, 1000, seed=9, start_step=2)
    try:
        for _ in range(4):
            (s, b), (js, jb) = ours.next(), theirs.next()
            assert s == js
            for k in ("tokens", "labels"):
                assert b[k].device.type == "cpu" and b[k].dtype == torch.int32
                np.testing.assert_array_equal(b[k].numpy(), np.asarray(jb[k]))
    finally:
        ours.close()
        theirs.close()


# -- shard_batch and the mesh ------------------------------------------------------------


def test_shard_batch_places_on_the_mesh_and_checks_the_split():
    mesh = make_mesh((4,), ("data",), device="cpu")
    b = shard_batch(lm_batch(0, 8, 16, 100), mesh)
    assert b["tokens"].shape == (8, 16) and b["tokens"].device.type == "cpu"
    with pytest.raises(ValueError, match="does not split over data axes"):
        shard_batch(lm_batch(0, 6, 16, 100), mesh)
    # a (2, 2) mesh over ("data", "model"): the batch splits over data only
    mesh2 = make_mesh((2, 2), ("data", "model"), device="cpu")
    shard_batch(lm_batch(0, 6, 16, 100), mesh2)
    with pytest.raises(ValueError):
        shard_batch(lm_batch(0, 6, 16, 100), mesh2, data_axes=("data", "model"))


def test_shard_map_hands_each_position_its_rows():
    mesh = make_mesh((4,), ("data",), device="cpu")
    raw = lm_batch(3, 8, 5, 50)
    b = shard_batch(raw, mesh)
    rows = shard_map(lambda t: t.clone(), mesh=mesh, in_specs=P("data"),
                     out_specs=P("data"))(b["tokens"])
    np.testing.assert_array_equal(rows.numpy(), raw["tokens"])
    firsts = shard_map(lambda t: t[:1], mesh=mesh, in_specs=P("data"),
                       out_specs=P("data"))(b["tokens"])
    np.testing.assert_array_equal(firsts.numpy(), raw["tokens"][::2])


def test_shard_batch_without_mesh_matches_repro():
    raw = lm_batch(1, 2, 4, 10)
    ours, theirs = shard_batch(raw, device="cpu"), jdata.shard_batch(raw, None)
    for k in raw:
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(theirs[k]))


def test_entry_points_need_a_gpu_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: shard_batch(lm_batch(0, 2, 4, 10)),
                 lambda: LMDataPipeline(2, 4, 10, prefetch=False)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


# -- Prefetcher ----------------------------------------------------------------------------


def test_prefetcher_close_stops_and_restart_resumes():
    made = []

    def make(step):
        made.append(step)
        return step * 10

    pf = Prefetcher(make, start_step=3, depth=2)
    assert [next(pf) for _ in range(3)] == [(3, 30), (4, 40), (5, 50)]
    pf.close()
    assert not pf._thread.is_alive()
    n = len(made)
    # a closed prefetcher builds nothing more; a new one restarts at any step
    pf2 = Prefetcher(make, start_step=n + 3, depth=1)
    assert next(pf2) == (n + 3, (n + 3) * 10)
    pf2.close()
    assert not pf2._thread.is_alive()
    assert made[:3] == [3, 4, 5]


def test_prefetcher_depth_bounds_the_queue():
    pf = Prefetcher(lambda s: s, depth=2)
    try:
        import time
        time.sleep(0.3)
        assert pf._q.qsize() <= 2
    finally:
        pf.close()
