"""Coarse-grained packing of the port (``pack_spec`` / ``pack_tree`` /
``unpack_tree``) against repro's on the same numpy trees: the spec's fields
equal, the packed buffers bit-equal, and test_dsm.py's and
test_property.py's round trips (bf16 leaves included), each case run over a
fixed list of draws in place of hypothesis."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import dsm as jdsm  # noqa: E402
from repro_torch.core import PackSpec, pack_spec, pack_tree, unpack_tree  # noqa: E402

# leaf shapes of the trees below: scalars, an empty leaf, a leaf of exactly
# one package, leaves one past and one short of a package, nested dicts
SHAPE_SETS = [
    [(3, 5), (130,)],
    [(), (1,), (128,), (129,), (127,)],
    [(0,), (2, 3, 4), (7, 7)],
    [(13, 7), (5,)],
    [(300,), (1, 1), (64, 2)],
]
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs files in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _trees(shapes, seed, dtypes=("float32",)):
    """The same tree for both packages: numpy draws, leaf i in dtypes[i %
    len], nested one level under "inner" for every other leaf."""
    rng = np.random.default_rng(seed)
    jt, tt = {}, {}
    for i, s in enumerate(shapes):
        jdt, tdt = DTYPES[dtypes[i % len(dtypes)]]
        x = rng.normal(size=s).astype(np.float32)
        key = f"l{i}"
        jleaf, tleaf = jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)
        if i % 2:
            jt.setdefault("inner", {})[key], tt.setdefault("inner", {})[key] = jleaf, tleaf
        else:
            jt[key], tt[key] = jleaf, tleaf
    return jt, tt


def _bits(x) -> np.ndarray:
    """The bytes of a buffer of either package, as uint16 or uint32 words."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy().view(np.uint32)
    a = np.asarray(x)
    return a.view(np.uint16) if a.dtype.itemsize == 2 else a.view(np.uint32)


@pytest.mark.parametrize("shapes", SHAPE_SETS)
@pytest.mark.parametrize("package", [128, 32])
def test_pack_spec_fields_equal_repro(shapes, package):
    jt, tt = _trees(shapes, 0, ("float32", "bfloat16"))
    js, ts = jdsm.pack_spec(jt, package=package), pack_spec(tt, package=package)
    assert isinstance(ts, PackSpec)
    assert ts.offsets == js.offsets and ts.sizes == js.sizes and ts.total == js.total
    assert ts.shapes == js.shapes and ts.padding_waste == js.padding_waste
    assert [str(d).removeprefix("torch.") for d in ts.dtypes] == [str(d) for d in js.dtypes]


@pytest.mark.parametrize("shapes", SHAPE_SETS)
@pytest.mark.parametrize("leaf_dtypes", [("float32",), ("bfloat16",), ("float32", "bfloat16")])
@pytest.mark.parametrize("buf_dtype", ["float32", "bfloat16"])
def test_pack_tree_bit_equal_repro(shapes, leaf_dtypes, buf_dtype):
    jt, tt = _trees(shapes, 1, leaf_dtypes)
    js, ts = jdsm.pack_spec(jt), pack_spec(tt)
    jbuf = jdsm.pack_tree(jt, js, dtype=DTYPES[buf_dtype][0])
    tbuf = pack_tree(tt, ts, dtype=DTYPES[buf_dtype][1])
    assert tbuf.shape == jbuf.shape and tbuf.dtype == DTYPES[buf_dtype][1]
    np.testing.assert_array_equal(_bits(tbuf), _bits(jbuf))
    # unpacking repro's buffer with the port's spec gives repro's leaves
    back = unpack_tree(torch.from_numpy(np.array(jbuf, np.float32)).to(tbuf.dtype), ts)
    jback = jdsm.unpack_tree(jbuf, js)
    for tl, jl in zip(jax.tree.leaves(back, is_leaf=lambda x: isinstance(x, torch.Tensor)),
                      jax.tree.leaves(jback)):
        np.testing.assert_array_equal(_bits(tl), _bits(jl))


@pytest.mark.parametrize("seed", range(6))
def test_pack_unpack_roundtrip_2d(seed):
    """test_property.py:11-24: random 2-D leaves come back exactly; here with
    bf16 leaves among them."""
    rng = np.random.default_rng(100 + seed)
    shapes = [tuple(rng.integers(1, 9, size=2)) for _ in range(rng.integers(1, 6))]
    _, tt = _trees(shapes, seed, ("float32", "bfloat16"))
    spec = pack_spec(tt)
    back = unpack_tree(pack_tree(tt, spec), spec)
    for k, v in tt.items():
        got = back[k]
        if isinstance(v, dict):
            for kk in v:
                assert got[kk].dtype == v[kk].dtype and torch.equal(got[kk], v[kk])
        else:
            assert got.dtype == v.dtype and torch.equal(got, v)


@pytest.mark.parametrize("sizes", [[1], [40, 3], [7, 128, 129, 1], [33, 2, 40, 40, 17, 1]])
def test_pack_roundtrip(sizes):
    """test_dsm.py's round trip: package-aligned buffer, leaves back."""
    tree = {f"l{i}": torch.arange(float(n)) for i, n in enumerate(sizes)}
    spec = pack_spec(tree)
    buf = pack_tree(tree, spec)
    assert buf.shape[0] % 128 == 0
    back = unpack_tree(buf, spec)
    for k in tree:
        assert torch.equal(back[k], tree[k])


def test_pack_mixed_shapes_dtypes():
    tree = {"a": torch.ones((3, 5)), "b": torch.zeros((130,)),
            "c": torch.arange(4, dtype=torch.int32)}
    spec = pack_spec(tree)
    back = unpack_tree(pack_tree(tree, spec), spec)
    assert back["a"].shape == (3, 5) and back["b"].shape == (130,)
    assert back["c"].dtype == torch.int32 and torch.equal(back["c"], tree["c"])


def test_pack_tree_is_differentiable_and_spec_holds_no_tensor():
    """Packing a tree of parameters keeps the graph (as JAX's pack does);
    the spec's structure holds placeholders, not the packed tensors."""
    w = torch.randn(3, 4, requires_grad=True)
    tree = {"w": w, "b": torch.ones(5)}
    spec = pack_spec(tree)
    assert not any(isinstance(x, torch.Tensor) for x in spec.treedef.values())
    (pack_tree(tree, spec) * 2).sum().backward()
    assert torch.equal(w.grad, torch.full((3, 4), 2.0))


def test_empty_tree_packs_to_nothing():
    spec = pack_spec({})
    assert spec.total == 0 and pack_tree({}, spec).shape == (0,)


def test_tree_walks_free_their_leaves_without_the_cyclic_collector():
    """Flattening, unflattening and mapping a tree leave no reference cycle
    behind: a train step's gradient tree is freed when its last name goes,
    not at the next collection (a nested recursive walk held it)."""
    import gc
    import weakref
    from repro_torch.utils.tree import tree_leaves, tree_map, tree_unflatten
    gc.disable()
    try:
        leaf = torch.ones(3)
        ref = weakref.ref(leaf)
        tree = {"a": leaf, "b": [torch.zeros(2), {"c": torch.ones(1)}]}
        spec = pack_spec(tree)
        unpack_tree(pack_tree(tree, spec), spec)
        tree_unflatten(tree, tree_leaves(tree))
        tree_map(lambda x, y: x * y, tree, tree)
        del tree, leaf
        assert ref() is None
    finally:
        gc.enable()
