"""The port's weights from a seed, on the CPU: the stream pinned against an
independent numpy model of its hash (``seed_model.py``), every entry point
that draws (``build_model``, ``serve``'s and ``train``'s builds,
``build_cell``'s weights and batch) deterministic in the seed at every
family's ``smoke_config``, and every leaf with ``repro``'s init statistics
(a fan-in truncated normal cut at ±2, the embeddings N(0, 0.02²), the
constant leaves equal).  ``test_torch_seed_card.py`` holds the same draws on
the card to these bits."""

import importlib
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from seed_model import SPLITMIX_SEED0, key_of, normal, stream, ulps  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models.build import build_model as jax_build_model  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.launch import make_host_mesh  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch.steps import build_cell  # noqa: E402
from repro_torch.models import build_model, common  # noqa: E402
from repro_torch.models.convert import jax_tree_to_params  # noqa: E402
from repro_torch.utils.tree import tree_leaves  # noqa: E402

ttrain = importlib.import_module("repro_torch.launch.train")   # the package exports train()
ARCHS = ["qwen3-1.7b", "starcoder2-3b", "mamba2-2.7b", "zamba2-2.7b", "moonshot-v1-16b-a3b",
         "deepseek-v3-671b", "llama-3.2-vision-90b", "hubert-xlarge"]
TRUNC_STD = 0.8796256610342398        # the std of N(0, 1) cut at ±2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs files in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _smoke(arch, **kw):
    return configs.smoke_config(configs.get_arch(arch)).replace(**kw)


def _leaves(model):
    return {k: v.detach() for k, v in model.state_dict().items()}


def _equal(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


# -- the stream --------------------------------------------------------------------------


def test_stream_is_splitmix64():
    """Key 0's first values are splitmix64's from state 0; keys and a few
    hundred values of several (seed, leaf) pairs, at the start, across a
    chunk boundary and past 2^32, equal the numpy model's bits."""
    got = common.hash_bits(0, 0, 3, "cpu").numpy().view(np.uint64)
    assert tuple(int(v) for v in got) == SPLITMIX_SEED0
    for seed, leaf in ((0, 0), (0, 1), (1, 0), (12345, 77), (2**64 - 1, 3)):
        key = common.leaf_key(seed, leaf)
        assert key == key_of(seed, leaf)
        for start in (0, common.DRAW_CHUNK - 100, 2**32 + 5):
            got = common.hash_bits(key, start, 300, "cpu").numpy().view(np.uint64)
            np.testing.assert_array_equal(got, stream(key, start, 300))


@pytest.mark.parametrize("kind", ["normal", "truncated_normal"])
def test_draw_against_the_numpy_model(kind):
    """The transform: √2·erfinv in float64 on the stream's bits, rounded to
    float32, within one float32 step of scipy's (two float64 erfinvs may
    round a value at a float32 boundary apart); the scale one rounding."""
    key, n = common.leaf_key(7, 2), 5000
    got = common.draw(key, (n,), kind=kind).numpy()
    want = normal(stream(key, 0, n), kind == "truncated_normal")
    assert ulps(got, want.astype(np.float32)) <= 1
    scaled = common.draw(key, (n,), kind=kind, scale=0.125).numpy()
    np.testing.assert_array_equal(scaled, got * np.float32(0.125))


def test_draw_in_chunks_is_one_draw(monkeypatch):
    key = common.leaf_key(3, 9)
    whole = common.draw(key, (37, 53), kind="truncated_normal", dtype=torch.bfloat16)
    ints = common.draw(key, (37, 53), kind="integers", high=1000, dtype=torch.int32)
    monkeypatch.setattr(common, "DRAW_CHUNK", 100)
    assert torch.equal(common.draw(key, (37, 53), kind="truncated_normal",
                                   dtype=torch.bfloat16), whole)
    assert torch.equal(common.draw(key, (37, 53), kind="integers", high=1000,
                                   dtype=torch.int32), ints)
    z = stream(key, 0, 37 * 53)
    np.testing.assert_array_equal(ints.numpy().ravel(),
                                  ((z & np.uint64(2**63 - 1)) % np.uint64(1000)).astype(np.int32))


def test_draw_statistics():
    x = common.draw(common.leaf_key(0, 0), (400_000,), kind="truncated_normal").double()
    assert float(x.abs().max()) <= 2.0
    assert abs(float(x.mean())) < 5e-3 and abs(float(x.std()) - TRUNC_STD) < 5e-3
    y = common.draw(common.leaf_key(0, 1), (400_000,)).double()
    assert abs(float(y.mean())) < 5e-3 and abs(float(y.std()) - 1.0) < 5e-3
    assert float(y.abs().max()) > 4.0                    # not cut
    u = common.draw(common.leaf_key(0, 2), (400_000,), kind="integers", high=7,
                    dtype=torch.int64)
    counts = torch.bincount(u)
    assert len(counts) == 7 and int(counts.min()) > 56_000


def test_meta_draws_nothing():
    s = common.InitStream(0)
    t = s.draw((10**12,), device="meta")
    assert t.device.type == "meta" and s.leaves == 1


def test_an_init_refuses_a_generator():
    with pytest.raises(TypeError, match="InitStream"):
        common.dense_init((4, 4), generator=torch.Generator())


# -- the entry points ----------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_build_model_is_deterministic_in_the_seed(arch):
    """The same seed, as an int or a torch.Generator's (its state not read),
    gives the same bits; another seed other weights."""
    cfg = _smoke(arch)
    a = _leaves(build_model(cfg, device="cpu", generator=5))
    g = torch.Generator().manual_seed(5)
    torch.randn(100, generator=g)                        # the state moves; the seed not
    assert _equal(a, _leaves(build_model(cfg, device="cpu", generator=g)))
    b = _leaves(build_model(cfg, device="cpu", generator=6))
    drawn = [k for k in a if a[k].numel() > 1 and a[k].std() > 0 and not k.endswith("A_log")]
    assert drawn and all(not torch.equal(a[k], b[k]) for k in drawn)
    assert _equal(_leaves(build_model(cfg, device="cpu")),
                  _leaves(build_model(cfg, device="cpu", generator=0)))


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "zamba2-2.7b", "deepseek-v3-671b"])
def test_a_bf16_build_is_the_fp32_build_rounded(arch):
    """Each leaf is drawn in float32 and cast: a bf16 build's leaves are the
    float32 build's rounded to bf16 (the router stays float32)."""
    f32 = _leaves(build_model(_smoke(arch), device="cpu", generator=2))
    bf16 = _leaves(build_model(_smoke(arch, dtype="bfloat16"), device="cpu", generator=2))
    for k, v in bf16.items():
        assert torch.equal(v, f32[k].to(v.dtype)), k


def _captured(monkeypatch, module):
    built = []

    def capture(cfg, device=None, generator=None, **kw):
        built.append(build_model(cfg, device=device, generator=generator, **kw))
        return built[-1]

    monkeypatch.setattr(module, "build_model", capture)
    return built


@pytest.mark.parametrize("arch", [a for a in ARCHS if a != "hubert-xlarge"])
def test_serve_builds_the_seeds_weights(arch, monkeypatch):
    built = _captured(monkeypatch, tserve)
    for _ in range(2):
        tserve.serve(arch, smoke=True, batch=1, prompt_len=2, gen=1, seed=4, device="cpu")
    want = _leaves(build_model(_smoke(arch), device="cpu", generator=4))
    assert all(_equal(_leaves(m), want) for m in built) and len(built) == 2


@pytest.mark.parametrize("arch", ARCHS)
def test_train_builds_the_seeds_weights(arch, monkeypatch):
    built = _captured(monkeypatch, ttrain)
    for _ in range(2):
        assert ttrain.train(arch, smoke=True, steps=0, seed=4, device="cpu") == []
    want = _leaves(build_model(_smoke(arch), device="cpu", generator=4))
    assert all(_equal(_leaves(m), want) for m in built) and len(built) == 2


@pytest.mark.parametrize("arch,kind", [
    (arch, kind) for arch in ("qwen3-1.7b", "zamba2-2.7b", "llama-3.2-vision-90b",
                              "hubert-xlarge")
    for kind in ("train", "prefill", "decode")
    if not (arch == "hubert-xlarge" and kind == "decode")])      # encoder-only: no decode
def test_build_cell_draws_the_seeds_weights_and_batch(arch, kind):
    """The cell's weights are build_model's from the seed, its batch drawn
    after them from the same stream: the same for the same seed (tokens
    below the vocabulary, float inputs N(0, 1)), another for another."""
    cfg = _smoke(arch)
    shape = ShapeSpec(f"small_{kind}", 32, 2, kind)
    mesh = make_host_mesh(1, 1, device="cpu")

    def batch(seed):
        cell = build_cell(cfg, shape, mesh, device="cpu", generator=seed)
        return cell, cell.args[2] if kind == "train" else cell.args[1]

    (c1, b1), (_, b2), (_, b3) = batch(3), batch(3), batch(4)
    assert _equal(_leaves(c1.model), _leaves(build_model(cfg, device="cpu", generator=3)))
    l1, l2, l3 = tree_leaves(b1), tree_leaves(b2), tree_leaves(b3)
    assert all(torch.equal(x, y) for x, y in zip(l1, l2))
    drawn = {k: v for k, v in b1.items() if k not in ("cache", "pos")}
    assert drawn and all(not torch.equal(v, b3[k]) for k, v in drawn.items())
    for k, v in drawn.items():
        if v.dtype.is_floating_point:
            assert abs(float(v.float().std()) - 1.0) < 0.2, k
        else:
            assert 0 <= int(v.min()) and int(v.max()) < cfg.vocab, k


# -- repro's init statistics ------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_every_leaf_keeps_repros_init(arch):
    """Leaf by leaf against repro's init of the same config: the constant
    leaves (zeros, ones, A_log's linspace) equal; a drawn leaf cut at ±2 /
    √fan_in where repro's is (its bound read off repro's own leaf), its std
    within 15% of repro's where it has 2,000 values or more, its mean near
    zero; the embeddings at 0.02."""
    cfg = _smoke(arch)
    port = build_model(cfg, device="cpu", generator=0)
    jm = jax_build_model(jconfigs.smoke_config(jconfigs.get_arch(arch)))
    jp = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    ref = jax_tree_to_params(port, jp)
    for name, p in port.named_parameters():
        x, r = p.detach().double(), ref[name].double()
        if float(r.std()) == 0:
            assert torch.equal(x, r), name
            continue
        if name.endswith("A_log"):                       # log(linspace(1, 16, H))
            torch.testing.assert_close(x, r, rtol=1e-6, atol=0, msg=name)
            continue
        assert float(x.std()) > 0, name
        if name.endswith("embed.table"):
            assert abs(float(x.std()) - 0.02) < 0.002, name
            continue
        # repro's fan-in std from its own leaf: the cut sits at 2 std / 0.8796
        if x.numel() >= 2000:
            assert abs(float(x.std()) / float(r.std()) - 1.0) < 0.15, name
            assert abs(float(x.mean())) < 0.1 * float(r.std()), name
        bound = 2.0 * float(r.std()) / TRUNC_STD
        assert float(x.abs().max()) <= bound * 1.15, name
        assert float(r.abs().max()) <= bound * 1.15, name


def test_fan_in_of_every_dense_leaf():
    """dense_init's cut and scale by its fan-in axis: max |x| at most
    2 / √fan_in, std 0.8796 / √fan_in; embed_init N(0, 0.02²)."""
    s = common.InitStream(0)
    for shape, in_axis in (((512, 384), 0), ((16, 64, 256), 1), ((300, 2000), -2)):
        x = common.dense_init(shape, in_axis=in_axis, generator=s).double()
        std = 1.0 / math.sqrt(shape[in_axis])
        assert float(x.abs().max()) <= 2.0 * std * (1 + 2**-22)
        assert abs(float(x.std()) / (TRUNC_STD * std) - 1.0) < 0.01
    e = common.embed_init((1000, 300), generator=s).double()
    assert abs(float(e.std()) - 0.02) < 2e-4 and float(e.abs().max()) > 3.5 * 0.02
