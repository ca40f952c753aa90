"""The port's optimizers, schedules, ZeRO-1 and error-feedback compression
against repro's on the same numpy inputs (the CPU: the port's kernels run
their plain versions).  tests/test_optim.py is mirrored case by case, its
hypothesis draws replaced by a fixed list of seeds; each optimizer and
schedule is held to repro's over five steps at rtol 1e-6, atol 1e-8; the
error feedback and its accumulate over 4 mesh positions are bit-equal with
repro's ``blocked_topk_sparsify`` + ``densify`` summed in position order;
ZeRO-1 is held against a replicated AdamW (test_spmd.py:33's mirror)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import optim as joptim  # noqa: E402
from repro.core.sparse import blocked_topk_sparsify as j_topk, densify as j_densify  # noqa: E402
from repro_torch.core import pack_spec  # noqa: E402
from repro_torch.core.compat import axis_index, axis_size, make_mesh, run_positions  # noqa: E402
from repro_torch.core.sparse import blocked_topk_sparsify, densify  # noqa: E402
from repro_torch import optim as toptim  # noqa: E402
from repro_torch.optim import (  # noqa: E402
    AdamState, EFState, adam, adamw, apply_updates, clip_by_global_norm, compressed_accumulate,
    compression_ratio, ef_init, global_norm, sgd, warmup_cosine, zero1_gather_params,
    zero1_init, zero1_update)
from repro_torch.utils.tree import tree_leaves, tree_map  # noqa: E402

TOL = dict(rtol=1e-6, atol=1e-8)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs files in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.tensor(np.asarray(x, np.float32))


# -- tests/test_optim.py, case by case ------------------------------------------------


def test_sgd_matches_manual():
    params = {"w": _t([1.0, 2.0])}
    grads = {"w": _t([0.5, -0.5])}
    opt = sgd(lr=0.1)
    upd, _ = opt.update(grads, opt.init(params))
    new = apply_updates(params, upd)
    np.testing.assert_allclose(new["w"].numpy(), [0.95, 2.05], rtol=1e-6)


def test_momentum():
    opt = sgd(lr=1.0, momentum=0.9)
    p = {"w": torch.zeros(1)}
    st_ = opt.init(p)
    g = {"w": torch.ones(1)}
    upd1, st_ = opt.update(g, st_, p, 0)
    upd2, st_ = opt.update(g, st_, p, 1)
    np.testing.assert_allclose(upd1["w"].numpy(), -1.0)
    np.testing.assert_allclose(upd2["w"].numpy(), -1.9, rtol=1e-6)


def test_adam_first_step_is_lr_sized():
    opt = adam(lr=1e-3)
    p = {"w": _t([1.0])}
    g = {"w": _t([123.0])}
    upd, _ = opt.update(g, opt.init(p), p, 0)
    np.testing.assert_allclose(upd["w"].numpy(), -1e-3, rtol=1e-4)


def test_adamw_decay():
    opt_w = adamw(lr=1e-2, weight_decay=0.1)
    opt_0 = adamw(lr=1e-2, weight_decay=0.0)
    p = {"w": _t([10.0])}
    g = {"w": _t([1.0])}
    uw, _ = opt_w.update(g, opt_w.init(p), p, 0)
    u0, _ = opt_0.update(g, opt_0.init(p), p, 0)
    np.testing.assert_allclose((uw["w"] - u0["w"]).numpy(), -1e-2 * 0.1 * 10.0, rtol=1e-5)


def test_clip_and_norm():
    g = {"a": _t([3.0]), "b": _t([4.0])}
    np.testing.assert_allclose(float(global_norm(g)), 5.0)
    clipped, norm = clip_by_global_norm(g, 1.0)
    np.testing.assert_allclose(float(global_norm(clipped)), 1.0, rtol=1e-5)
    assert float(norm) == 5.0


def test_warmup_cosine_shape():
    sched = warmup_cosine(1.0, 10, 100)
    assert float(sched(0)) == 0.0
    np.testing.assert_allclose(float(sched(10)), 1.0, rtol=1e-5)
    assert float(sched(100)) < 0.2


@pytest.mark.parametrize("seed", range(7))
def test_error_feedback_identity(seed):
    """sent + residual == corrected gradient, exactly (lossless bookkeeping)."""
    rng = np.random.default_rng(seed)
    g = _t(rng.normal(size=(256,)))
    ef = ef_init(256, device="cpu")
    corrected = g + ef.residual
    idx, vals = blocked_topk_sparsify(corrected, 16)
    sent = densify(idx, vals, 256)
    residual = corrected - sent
    assert torch.equal(sent + residual, corrected)


# -- each optimizer and schedule against repro's, five steps ---------------------------


OPTIMIZERS = {
    "sgd": lambda o: o.sgd(lr=0.1),
    "sgd_momentum": lambda o: o.sgd(lr=0.05, momentum=0.9),
    "sgd_nesterov": lambda o: o.sgd(lr=0.05, momentum=0.9, nesterov=True),
    "sgd_schedule": lambda o: o.sgd(lr=o.warmup_cosine(0.1, 2, 5)),
    "adam": lambda o: o.adam(lr=1e-2),
    "adam_decay": lambda o: o.adam(lr=1e-2, b2=0.99, eps=1e-6, weight_decay=0.05),
    "adamw": lambda o: o.adamw(lr=3e-3),
    "adamw_warmup_cosine": lambda o: o.adamw(lr=o.warmup_cosine(3e-3, 1, 5)),
}


def _draw_tree(rng, scale=1.0):
    return {"w": rng.normal(size=(6, 5)) * scale, "b": rng.normal(size=(5,)) * scale,
            "blocks": {"0": rng.normal(size=(3, 4, 2)) * scale, "1": rng.normal(size=(7,))}}


def _np32(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_five_steps_vs_repro(name):
    rng = np.random.default_rng(3)
    p0 = _np32(_draw_tree(rng))
    jopt, topt = OPTIMIZERS[name](joptim), OPTIMIZERS[name](toptim)
    jp = jax.tree.map(jnp.asarray, p0)
    tp = jax.tree.map(torch.from_numpy, p0)
    jst, tst = jopt.init(jp), topt.init(tp)
    for step in range(5):
        g = _np32(_draw_tree(rng, scale=0.5 + step))
        ju, jst = jopt.update(jax.tree.map(jnp.asarray, g), jst, jp, step)
        tu, tst = topt.update(jax.tree.map(torch.from_numpy, g), tst, tp, step)
        jp, tp = joptim.apply_updates(jp, ju), apply_updates(tp, tu)
        for a, b in zip(tree_leaves(tu), jax.tree.leaves(ju)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
        for a, b in zip(tree_leaves(tp), jax.tree.leaves(jp)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
        for a, b in zip(tree_leaves(tst), jax.tree.leaves(jst)):
            assert a.dtype == torch.float32
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    if name.startswith("adam"):
        assert isinstance(tst, AdamState)


@pytest.mark.parametrize("args", [(1.0, 10, 100), (3e-4, 5, 100), (0.1, 0, 7), (2.0, 3, 3),
                                  (1e-3, 1, 20, 0.3)])
def test_warmup_cosine_vs_repro(args):
    js, ts = joptim.warmup_cosine(*args), warmup_cosine(*args)
    for step in range(0, 110, 3):
        got = ts(step)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(js(step)), **TOL)


def test_global_norm_and_clip_vs_repro():
    rng = np.random.default_rng(5)
    g = _np32(_draw_tree(rng, scale=3.0))
    jg, tg = jax.tree.map(jnp.asarray, g), jax.tree.map(torch.from_numpy, g)
    np.testing.assert_allclose(float(global_norm(tg)), float(joptim.global_norm(jg)), **TOL)
    for max_norm in (0.5, 1e6):
        (tc, tn), (jc, jn) = clip_by_global_norm(tg, max_norm), joptim.clip_by_global_norm(jg, max_norm)
        np.testing.assert_allclose(float(tn), float(jn), **TOL)
        for a, b in zip(tree_leaves(tc), jax.tree.leaves(jc)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def test_clip_promotes_bf16_grads_as_jax_does():
    """A bf16 gradient times the fp32 scale is fp32 in JAX; the port's too."""
    g = {"w": torch.tensor([3.0, 4.0]).bfloat16()}
    clipped, _ = clip_by_global_norm(g, 1.0)
    jclipped, _ = joptim.clip_by_global_norm({"w": jnp.asarray([3.0, 4.0], jnp.bfloat16)}, 1.0)
    assert clipped["w"].dtype == torch.float32 and jclipped["w"].dtype == jnp.float32
    np.testing.assert_array_equal(clipped["w"].numpy(), np.asarray(jclipped["w"]))


def test_apply_updates_keeps_param_dtype():
    p = {"w": torch.ones(3, dtype=torch.bfloat16)}
    u = {"w": torch.full((3,), 0.001)}
    out = apply_updates(p, u)
    jout = joptim.apply_updates({"w": jnp.ones(3, jnp.bfloat16)}, {"w": jnp.full((3,), 0.001)})
    assert out["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(out["w"].float().numpy(), np.asarray(jout["w"], np.float32))


# -- error feedback around the SPARSE accumulate, 4 positions --------------------------


@pytest.mark.parametrize("k", [16, 64, 160])
def test_compressed_accumulate_bit_equal_repro(k):
    """Each position's residual is repro's corrected - densify(topk) on its
    gradient; the total is repro's densify of every position's sent pairs,
    summed in position order — bit for bit.  V 512 is one block: k 16 and
    64 select as topk_compress's argmax body does, k 160 (past
    BITONIC_MIN_K) as its bitonic body; on the CPU both are its plain
    version."""
    n_pos, V = 4, 512
    rng = np.random.default_rng(k)
    g = rng.normal(size=(n_pos, V)).astype(np.float32)
    g[:, rng.random(V) < 0.1] = 0.0               # some zeros in the selection
    mesh = make_mesh((n_pos,), ("data",), device="cpu")

    def position(i):
        total, ef = compressed_accumulate(torch.from_numpy(g[i]), ef_init(V, device="cpu"),
                                          "data", k)
        return total, ef

    outs = run_positions(mesh, position)
    expect_total = np.zeros(V, np.float32)
    for i in range(n_pos):
        corrected = jnp.asarray(g[i]) + jnp.zeros((V,), jnp.float32)
        sent = j_densify(*j_topk(corrected, k), V)
        np.testing.assert_array_equal(outs[i][1].residual.numpy(), np.asarray(corrected - sent))
        assert isinstance(outs[i][1], EFState)
        pairs = j_topk(sent, k)
        expect_total = expect_total + np.asarray(j_densify(*pairs, V))
    for total, _ in outs:
        np.testing.assert_array_equal(total.numpy(), expect_total)


def test_compressed_accumulate_identity_per_position():
    """sent + residual == corrected on every position, with a residual
    carried in from an earlier step."""
    n_pos, V, k = 4, 300, 24
    rng = np.random.default_rng(11)
    g = rng.normal(size=(n_pos, V)).astype(np.float32)
    r = (0.1 * rng.normal(size=(n_pos, V))).astype(np.float32)
    mesh = make_mesh((n_pos,), ("data",), device="cpu")

    def position(i):
        _, ef = compressed_accumulate(torch.from_numpy(g[i]), EFState(torch.from_numpy(r[i])),
                                      "data", k)
        corrected = torch.from_numpy(g[i]) + torch.from_numpy(r[i])
        sent = densify(*blocked_topk_sparsify(corrected, k), V)
        return bool(torch.equal(sent + ef.residual, corrected))

    assert run_positions(mesh, position) == [True] * n_pos
    assert compression_ratio(1000, 25) == joptim.compression_ratio(1000, 25) == 0.05


def test_ef_init_needs_a_device_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ef_init(8)


# -- ZeRO-1 against replicated AdamW (test_spmd.py:33) ---------------------------------


def _zero1_run(n_pos, params, grads_per_pos, opt, steps, compute_dtype=torch.bfloat16):
    """``steps`` zero1_update steps on ``n_pos`` positions; returns position
    0's params after each step and the fp32 master gathered after each."""
    spec = pack_spec(params)
    mesh = make_mesh((n_pos,), ("data",), device="cpu")

    def position(i):
        st = zero1_init(params, opt, axis_size("data"), axis_index("data"), spec)
        out = []
        for s in range(steps):
            newp, st = zero1_update(grads_per_pos[s][i], st, opt, "data", spec,
                                    compute_dtype=compute_dtype)
            out.append((newp, zero1_gather_params(st, "data", spec, dtype=torch.float32)))
        assert st.step == steps
        return out

    return run_positions(mesh, position)[0]


def test_zero1_matches_replicated_adamw():
    """test_spmd.py:33 on 8 positions: bf16 params, one step, bf16 result
    within 2e-2 of a replicated fp32 AdamW on the mean gradient."""
    params = {"w": torch.ones((13, 7), dtype=torch.bfloat16),
              "b": torch.zeros((5,), dtype=torch.bfloat16)}
    opt = adamw(lr=0.1, weight_decay=0.0)
    grads = [{"w": torch.full((13, 7), float(i + 1)), "b": torch.full((5,), .5 * (i + 1))}
             for i in range(8)]
    mean_g = tree_map(lambda *g: sum(g) / 8.0, *grads)
    p32 = tree_map(lambda p: p.float(), params)
    upd, _ = opt.update(mean_g, opt.init(p32), p32, 0)
    ref = tree_map(lambda p, u: p.float() + u, params, upd)
    got, _ = _zero1_run(8, params, [grads], opt, 1)[0]
    for k in ("w", "b"):
        assert got[k].dtype == torch.bfloat16
        np.testing.assert_allclose(got[k].float().numpy(), ref[k].numpy(), rtol=2e-2, atol=2e-2)


def test_zero1_master_equals_replicated_adamw_over_steps():
    """Four positions, three steps of different gradients: the fp32 master is
    a replicated AdamW on the position-order mean gradient, and equals
    repro's replicated AdamW on the same numbers (rtol 1e-6)."""
    rng = np.random.default_rng(2)
    p0 = _np32(_draw_tree(rng))
    params = jax.tree.map(torch.from_numpy, p0)
    n_pos, steps = 4, 3
    grads = [[jax.tree.map(torch.from_numpy, _np32(_draw_tree(rng))) for _ in range(n_pos)]
             for _ in range(steps)]
    sched = lambda o: o.adamw(lr=o.warmup_cosine(1e-2, 1, 3), weight_decay=0.1)  # noqa: E731
    outs = _zero1_run(n_pos, params, grads, sched(toptim),
                      steps, compute_dtype=None)
    jopt = sched(joptim)
    jp = jax.tree.map(jnp.asarray, p0)
    jst = jopt.init(jp)
    tp, topt = params, sched(toptim)
    tst = topt.init(tp)
    for s in range(steps):
        mean_t = tree_map(lambda *g: (g[0] + g[1] + g[2] + g[3]) / n_pos, *grads[s])
        tu, tst = topt.update(mean_t, tst, tp, s)
        tp = apply_updates(tp, tu)
        ju, jst = jopt.update(jax.tree.map(lambda t: jnp.asarray(t.numpy()), mean_t), jst, jp, s)
        jp = joptim.apply_updates(jp, ju)
        newp, master = outs[s]
        for got, want, jwant in zip(tree_leaves(master), tree_leaves(tp), jax.tree.leaves(jp)):
            assert torch.equal(got, want)          # the same arithmetic, element for element
            np.testing.assert_allclose(got.numpy(), np.asarray(jwant), **TOL)
        for got, want in zip(tree_leaves(newp), tree_leaves(tp)):
            assert got.dtype == torch.float32 and torch.equal(got, want)
