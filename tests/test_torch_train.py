"""The port's training path against repro's on the CPU.

Weights come from repro's ``init`` and are carried across by
``load_jax_params`` (optimizer state by ``load_jax_opt_state``); batches are
the same numpy draws (the vlm's vision embeds and the audio family's frames
by repro's ``batch_for``).  ``loss_fn`` for the dense, ssm, hybrid, moe,
vlm and audio families at ``smoke_config`` (moe: moonshot with GQA,
deepseek with MLA and MTP): the loss and its metrics (ce, aux, mtp) within 1e-5 relative, every
gradient leaf within 1e-4 of its max |g|, plain and under ``chunked_ce``,
``z_loss`` and
``bwd_bf16_boundary``; ``remat`` full and dots give the gradients of none.
``make_train_step`` against repro's; tests/test_system.py's training cases
mirrored; a run stopped in repro goes on in the port.  E's and F's wrappers
refuse a backward pass on the CPU too, and the two examples that train run
in subprocesses at a trimmed size."""

import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro import optim as joptim  # noqa: E402
from repro.ft import restore_checkpoint as j_restore  # noqa: E402
from repro.launch.steps import make_train_step as j_make_train_step  # noqa: E402
from repro.launch.train import batch_for as j_batch_for  # noqa: E402
from repro.launch.train import train as j_train  # noqa: E402
from repro.models.build import build_model as j_build_model  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.data import LMDataPipeline, lm_batch  # noqa: E402
from repro_torch.ft import restore_checkpoint as t_restore  # noqa: E402
from repro_torch.kernels.flash_attention.kernel import (  # noqa: E402
    flash_attention_bhsd, flash_attention_gqa, gqa_plain)
from repro_torch.kernels.ssd_scan.kernel import ssd_scan, ssd_scan_bh  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import ssd_scan_plain  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.launch.steps import make_train_step  # noqa: E402
from repro_torch.models import build_model, load_jax_opt_state, load_jax_params  # noqa: E402
from repro_torch.models.convert import jax_tree_to_params  # noqa: E402
from repro_torch.optim import AdamState, adamw, warmup_cosine  # noqa: E402
from repro_torch.utils.tree import tree_leaves  # noqa: E402

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
FAMILIES = ["qwen3-1.7b", "mamba2-2.7b", "zamba2-2.7b", "moonshot-v1-16b-a3b",
            "deepseek-v3-671b", "llama-3.2-vision-90b", "hubert-xlarge"]
VARIANTS = {"plain": {}, "chunked_ce": dict(chunked_ce=True, ce_chunk=100),
            "z_loss": dict(z_loss=1e-3), "bwd_bf16_boundary": dict(bwd_bf16_boundary=True)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs files in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _model_pair(arch, seed=0, **overrides):
    jcfg = jconfigs.smoke_config(jconfigs.get_arch(arch)).replace(**overrides)
    tcfg = configs.smoke_config(configs.get_arch(arch)).replace(**overrides)
    jm = j_build_model(jcfg)
    jp = _np_tree(jm.init(jax.random.PRNGKey(seed)))
    tm = load_jax_params(build_model(tcfg, device="cpu"), jp)
    return jm, jp, tm


def _batch(cfg, step=0, B=2, T=16):
    """``lm_batch``'s tokens as the family's inputs, by repro's ``batch_for``
    (the audio family's frames, the vlm's vision embeds), as numpy."""
    raw = lm_batch(step, B, T, cfg.vocab, seed=1)
    return {k: np.array(v) for k, v in j_batch_for(cfg, None, raw).items()}


def _grads(tm, batch):
    tm.requires_grad_(True)
    tree = tm.param_tree()
    loss, metrics = tm.loss_fn({k: torch.from_numpy(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, list(tree.values()))
    return loss, metrics, dict(zip(tree, grads))


def _close_grads(ours: dict, theirs: dict, scale=1e-4):
    assert ours.keys() == theirs.keys()
    for name, g in ours.items():
        want = theirs[name].numpy()
        bound = scale * max(float(np.abs(want).max()), 1e-30)
        np.testing.assert_allclose(g.numpy(), want, rtol=0, atol=bound, err_msg=name)


# -- loss_fn and its gradients ----------------------------------------------------------


class _Recorded(torch.autograd.Function):
    """The port's bf16 boundary, its fp32 cotangent kept under its label."""

    @staticmethod
    def forward(ctx, x, label, cots):
        ctx.label, ctx.cots = label, cots
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        ctx.cots[ctx.label] = g.detach().clone()
        return g.to(torch.bfloat16).to(g.dtype), None, None


def _one_rounding(monkeypatch, tm, batch):
    """The port's gradients under ``bwd_bf16_boundary``, with repro made to
    round each boundary's cotangent as the port did.

    Each package rounds a boundary's fp32 cotangent to bf16.  An element
    that lies within the packages' fp32 difference of a bf16 midpoint
    rounds one way in one and the other way in the other: a step of 2^-8 of
    it that reaches every gradient upstream.  So the port's fp32 cotangents
    are recorded, one a boundary it passed, and repro's boundary (inside a
    layer scan, one trace for all layers) takes the recorded cotangent
    nearest its own, records its own under that one's label and returns the
    port's rounding of it.  Returns the port's (loss, metrics, grads) and
    both packages' fp32 cotangents by label."""
    from repro.models import build as jbuild
    from repro_torch.models import build as tbuild
    ours, theirs = {}, {}
    labels = iter(range(1 << 20))
    monkeypatch.setattr(tbuild, "bf16_boundary",
                        lambda x: _Recorded.apply(x, next(labels), ours))
    out = _grads(tm, batch)
    recorded = {k: g.numpy() for k, g in ours.items()}

    def port_rounding(g):
        g = np.array(g)                 # a copy: the callback's buffer is read-only
        label = min(recorded, key=lambda k: float(np.abs(recorded[k] - g).max()))
        theirs[label] = g
        return torch.from_numpy(recorded[label]).to(torch.bfloat16).float().numpy()

    @jax.custom_vjp
    def jax_boundary(x):
        return x

    def bwd(_, g):
        return (jax.pure_callback(port_rounding, jax.ShapeDtypeStruct(g.shape, g.dtype), g),)

    jax_boundary.defvjp(lambda x: (x, None), bwd)
    monkeypatch.setattr(jbuild, "bf16_boundary", jax_boundary)
    return out, recorded, theirs


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_fn_and_grads_vs_repro(arch, variant, monkeypatch):
    """Under ``bwd_bf16_boundary`` repro rounds each boundary's cotangent as
    the port did (``_one_rounding``), and the two packages' fp32 cotangents
    are held to each other as the gradients are."""
    jm, jp, tm = _model_pair(arch, **VARIANTS[variant])
    batch = _batch(tm.cfg)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    if variant == "bwd_bf16_boundary":
        (loss, metrics, grads), ours, theirs = _one_rounding(monkeypatch, tm, batch)
    (jloss, jmetrics), jgrads = jax.jit(jax.value_and_grad(jm.loss_fn, has_aux=True))(jp, jbatch)
    if variant == "bwd_bf16_boundary":
        assert theirs.keys() == ours.keys() and len(ours) == (
            tm.cfg.n_layers // tm.cfg.hybrid_period if tm.cfg.family == "hybrid"
            else tm.cfg.n_layers + tm.cfg.mtp if tm.cfg.family in ("dense", "moe", "vlm", "audio")
            else 0)
        _close_grads({k: torch.from_numpy(v) for k, v in ours.items()},
                     {k: torch.from_numpy(v) for k, v in theirs.items()})
    else:
        loss, metrics, grads = _grads(tm, batch)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    assert set(metrics) == set(jmetrics)
    for name in metrics:                  # ce, and the moe family's aux and mtp
        np.testing.assert_allclose(metrics[name].item(), float(jmetrics[name]), rtol=1e-5,
                                   atol=1e-7, err_msg=name)
    _close_grads(grads, jax_tree_to_params(tm, _np_tree(jgrads)))


@pytest.mark.parametrize("remat", ["full", "dots"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_remat_gives_the_gradients_of_none(arch, remat):
    _, jp, tm = _model_pair(arch)
    _, _, rm = _model_pair(arch, remat=remat)
    batch = _batch(tm.cfg, step=2)
    loss, _, grads = _grads(tm, batch)
    rloss, _, rgrads = _grads(rm, batch)
    assert rloss.item() == loss.item()
    for name in grads:
        torch.testing.assert_close(rgrads[name], grads[name], rtol=1e-6, atol=1e-9)


def test_remat_dots_keeps_the_matmuls_and_recomputes_the_rest():
    """Under "dots" the backward pass re-runs a layer's elementwise ops but
    none of its matmuls; under "full" it re-runs the matmuls too."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.mm = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func in (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
                        torch.ops.aten.addmm.default):
                self.mm += 1
            return func(*args, **(kwargs or {}))

    counts = {}
    for remat in ("none", "dots", "full"):
        _, _, tm = _model_pair("qwen3-1.7b", remat=remat)
        tm.requires_grad_(True)
        loss, _ = tm.loss_fn({k: torch.from_numpy(v) for k, v in _batch(tm.cfg).items()})
        with Count() as c:
            torch.autograd.grad(loss, list(tm.param_tree().values()))
        counts[remat] = c.mm
    assert counts["dots"] == counts["none"] < counts["full"]


def test_chunked_ce_matches_whole_ce_and_repro():
    from repro.models import common as jcommon
    from repro_torch.models.common import chunked_softmax_cross_entropy, softmax_cross_entropy
    rng = np.random.default_rng(0)
    h = rng.normal(size=(2, 5, 8)).astype(np.float32)
    w = rng.normal(size=(8, 37)).astype(np.float32)
    lab = rng.integers(0, 37, size=(2, 5)).astype(np.int32)
    whole = softmax_cross_entropy(torch.from_numpy(h) @ torch.from_numpy(w), torch.from_numpy(lab),
                                  z_loss=1e-2)
    for chunk in (8, 10, 37, 64):
        ours = chunked_softmax_cross_entropy(torch.from_numpy(h), torch.from_numpy(w),
                                             torch.from_numpy(lab), chunk=chunk, z_loss=1e-2)
        theirs = jcommon.chunked_softmax_cross_entropy(jnp.asarray(h), jnp.asarray(w),
                                                       jnp.asarray(lab), chunk=chunk, z_loss=1e-2)
        np.testing.assert_allclose(float(ours), float(theirs), rtol=1e-6)
        np.testing.assert_allclose(float(ours), float(whole), rtol=1e-6)


def test_bf16_boundary_rounds_only_the_cotangent():
    from repro_torch.models.common import bf16_boundary
    x = torch.tensor([1.0 + 2 ** -12, 3.0], requires_grad=True)
    y = bf16_boundary(x)
    assert torch.equal(y, x)
    (g,) = torch.autograd.grad(y, x, torch.tensor([1.0 + 2 ** -12, -0.3]))
    assert torch.equal(g, torch.tensor([1.0 + 2 ** -12, -0.3]).bfloat16().float())


# -- the train step ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", FAMILIES)
def test_make_train_step_vs_repro(arch):
    """Two steps of AdamW + warmup_cosine + clip 1.0 from the same weights:
    losses, grad norms, moments and parameters as repro's, the moments held
    as the gradients are.  ε is 1e-3 here: Adam's step lr·m̂/(√v̂+ε) at the
    default ε 1e-8 turns a |g| near 1e-8 into a step of up to lr, so the
    gradients' last bits move it by a good part of lr (1e-2 of it seen at
    a |g| of 6e-9 whose two values differ by 0.15%); at 1e-3 the step is a
    smooth function of the gradient.  The trainer's defaults are held end to
    end below (test_repro_run_goes_on_in_the_port)."""
    jm, jp, tm = _model_pair(arch)
    jopt = joptim.adamw(lr=joptim.warmup_cosine(1e-2, 1, 10), eps=1e-3)
    topt = adamw(lr=warmup_cosine(1e-2, 1, 10), eps=1e-3)
    jstep = jax.jit(j_make_train_step(jm, jopt))
    tstep = make_train_step(tm, topt)
    params = tm.param_tree()
    jstate, tstate = jopt.init(jp), topt.init(params)
    for step in range(2):
        batch = _batch(tm.cfg, step=step)
        jp, jstate, jloss, jmet = jstep(jp, jstate, {k: jnp.asarray(v) for k, v in batch.items()},
                                        step)
        params, tstate, loss, met = tstep(params, tstate, {k: torch.from_numpy(v)
                                                            for k, v in batch.items()}, step)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
        np.testing.assert_allclose(float(met["grad_norm"]), float(jmet["grad_norm"]), rtol=1e-4)
        want = jax_tree_to_params(tm, _np_tree(jp))
        for name, p in params.items():
            assert p is dict(tm.named_parameters())[name]          # updated in place
            np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), rtol=1e-5,
                                       atol=1e-6, err_msg=name)
        assert isinstance(tstate, AdamState)
        _close_grads(tstate.mu, jax_tree_to_params(tm, _np_tree(jstate.mu)))
        _close_grads(tstate.nu, jax_tree_to_params(tm, _np_tree(jstate.nu)))


def test_train_step_grad_reduce_dtype_as_repro():
    jm, jp, tm = _model_pair("qwen3-1.7b", grad_reduce_dtype="bfloat16")
    jopt, topt = joptim.adamw(lr=1e-3), adamw(lr=1e-3)
    batch = _batch(tm.cfg)
    _, jstate, jloss, jmet = jax.jit(j_make_train_step(jm, jopt))(
        jp, jopt.init(jp), {k: jnp.asarray(v) for k, v in batch.items()}, 0)
    params = tm.param_tree()
    _, tstate, loss, met = make_train_step(tm, topt)(
        params, topt.init(params), {k: torch.from_numpy(v) for k, v in batch.items()}, 0)
    np.testing.assert_allclose(float(met["grad_norm"]), float(jmet["grad_norm"]), rtol=1e-3)
    _close_grads(tstate.mu, jax_tree_to_params(tm, _np_tree(jstate.mu)), scale=1e-2)


# -- tests/test_system.py's training, and resuming across the packages -------------------------


def test_train_loss_decreases():
    losses = train("qwen3-1.7b", smoke=True, steps=15, batch=4, seq=64, lr=3e-3, device="cpu")
    assert len(losses) == 15
    assert losses[-1] < losses[0]
    assert np.isfinite(losses).all()


def test_checkpoint_resume_exact():
    with tempfile.TemporaryDirectory() as d:
        full = train("qwen3-1.7b", smoke=True, steps=10, batch=2, seq=32, seed=3, device="cpu")
        train("qwen3-1.7b", smoke=True, steps=6, batch=2, seq=32, ckpt_dir=d, ckpt_every=5,
              seed=3, total_steps=10, device="cpu")
        resumed = train("qwen3-1.7b", smoke=True, steps=10, batch=2, seq=32, ckpt_dir=d,
                        ckpt_every=5, seed=3, device="cpu")
    # the stream is stateless and the CPU's sums deterministic: the same bits
    assert resumed == full[6:]


def test_ssm_trains_and_resumes():
    """Resumed from step 3's checkpoint, the run's losses are the
    uninterrupted run's; and the weights of that checkpoint fit step 0's
    batch better than the initial weights did (``full[0]``).  Tokens are
    uniform over 256 classes, so the loss of 2 x 16 new tokens a step is
    noise about ln 256 from step to step: it is the trained batch's loss
    that falls."""
    cfg = configs.smoke_config(configs.get_arch("mamba2-2.7b"))
    with tempfile.TemporaryDirectory() as d:
        full = train("mamba2-2.7b", smoke=True, steps=6, batch=2, seq=16, lr=3e-3, device="cpu")
        train("mamba2-2.7b", smoke=True, steps=4, batch=2, seq=16, lr=3e-3, ckpt_dir=d,
              ckpt_every=3, total_steps=6, device="cpu")
        model = build_model(cfg, device="cpu", generator=1)
        params = model.param_tree()
        (saved, _), _, step = t_restore(d, (params, adamw(lr=3e-3).init(params)), device="cpu")
        resumed = train("mamba2-2.7b", smoke=True, steps=6, batch=2, seq=16, lr=3e-3,
                        ckpt_dir=d, device="cpu")
    assert resumed == full[4:] and step == 3
    pipe = LMDataPipeline(2, 16, cfg.vocab, seed=0, device="cpu")
    try:
        _, batch0 = pipe.next()
    finally:
        pipe.close()
    with torch.no_grad():
        for p, s in zip(tree_leaves(params), tree_leaves(saved)):
            p.copy_(s)
        trained = float(model.loss_fn(batch0)[0])
    assert trained < full[0] - 0.5, (trained, full[0])


def test_repro_run_goes_on_in_the_port():
    """repro trains to step 5 and checkpoints; its (params, AdamState) are
    carried into the port, which runs steps 6-9: losses within 1e-4 of
    repro's uninterrupted run."""
    kw = dict(smoke=True, batch=2, seq=32, seed=3)
    full = j_train("qwen3-1.7b", steps=10, **kw)
    jcfg = jconfigs.smoke_config(jconfigs.get_arch("qwen3-1.7b"))
    jm = j_build_model(jcfg)
    jopt = joptim.adamw(lr=joptim.warmup_cosine(3e-4, 1, 10))
    template = jm.init(jax.random.PRNGKey(3))
    with tempfile.TemporaryDirectory() as d:
        j_train("qwen3-1.7b", steps=6, ckpt_dir=d, ckpt_every=5, total_steps=10, **kw)
        (jparams, jstate), _, step = j_restore(d, (template, jopt.init(template)))
    assert step == 5
    tm = load_jax_params(build_model(configs.smoke_config(configs.get_arch("qwen3-1.7b")),
                                     device="cpu"), _np_tree(jparams))
    state = load_jax_opt_state(tm, _np_tree(jstate))
    assert isinstance(state, AdamState) and state.mu.keys() == tm.param_tree().keys()
    step_fn = make_train_step(tm, adamw(lr=warmup_cosine(3e-4, 1, 10)))
    params = tm.param_tree()
    pipe = LMDataPipeline(2, 32, tm.cfg.vocab, seed=3, start_step=6, device="cpu")
    losses = []
    try:
        for _ in range(6, 10):
            s, b = pipe.next()
            params, state, loss, _ = step_fn(params, state, b, s)
            losses.append(float(loss))
    finally:
        pipe.close()
    np.testing.assert_allclose(losses, full[6:], rtol=1e-4)


def test_load_jax_opt_state_shapes_and_kinds():
    _, jp, tm = _model_pair("mamba2-2.7b")
    mom = load_jax_opt_state(tm, jax.tree.map(lambda a: np.full_like(a, 2.0), jp))
    assert mom.keys() == tm.param_tree().keys()
    assert all(bool((t == 2.0).all()) and t.dtype == torch.float32 for t in mom.values())
    assert load_jax_opt_state(tm, ()) == ()
    bad = jax.tree.map(lambda a: a, jp)
    bad["head"] = {"w": np.zeros((3, 3), np.float32)}
    with pytest.raises(ValueError, match="head.w"):
        load_jax_opt_state(tm, joptim.AdamState(bad, bad))


def test_train_on_a_mesh_runs():
    """train(data=2) and train(model_axis=2) make a mesh of positions on the
    one device; a dense model's steps are those of the run without one.
    moe_impl="ep" on a (2, 2) mesh is held to repro in test_torch_ep.py."""
    from repro_torch.launch import shardings as sh
    saved = (dict(sh._AXIS_SIZES), sh.CURRENT_MESH)
    try:
        kw = dict(steps=2, batch=4, seq=16, device="cpu")
        want = train("qwen3-1.7b", **kw)
        for mesh in (dict(data=2), dict(model_axis=2)):
            assert train("qwen3-1.7b", **kw, **mesh) == want
            assert sh.CURRENT_MESH.shape == {"data": mesh.get("data", 1),
                                             "model": mesh.get("model_axis", 1)}
    finally:
        sh._AXIS_SIZES, sh.CURRENT_MESH = saved


def test_train_needs_a_gpu_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train("qwen3-1.7b", steps=1)


# -- E and F refuse a backward pass, on the CPU too --------------------------------------------


def _qkv(requires_grad):
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 8, 2, 2, 16, generator=g)
    k = torch.randn(2, 8, 2, 16, generator=g)
    v = torch.randn(2, 8, 2, 16, generator=g)
    return [t.requires_grad_(requires_grad) for t in (q, k, v)]


def _ssd_inputs(requires_grad):
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 16, 4, 8, generator=g)
    a = -torch.rand(2, 16, 4, generator=g)
    B = torch.randn(2, 16, 2, 8, generator=g)
    C = torch.randn(2, 16, 2, 8, generator=g)
    return [t.requires_grad_(requires_grad) for t in (x, a, B, C)]


def test_flash_attention_refuses_backward():
    q, k, v = _qkv(True)
    out = flash_attention_gqa(q, k, v, causal=True)
    assert out.grad_fn is not None
    assert torch.equal(out.detach(), gqa_plain(*_qkv(False), causal=True, q_offset=0))
    with pytest.raises(NotImplementedError, match="attention_impl='blocked'"):
        out.sum().backward()
    ob = flash_attention_bhsd(q[:, :, 0, 0].transpose(0, 1), k[:, :, 0].transpose(0, 1),
                              v[:, :, 0].transpose(0, 1), causal=False)
    with pytest.raises(NotImplementedError, match="no backward"):
        ob.sum().backward()


def test_ssd_scan_refuses_backward():
    x, a, B, C = _ssd_inputs(True)
    y = ssd_scan(x, a, B, C, chunk=8)
    assert torch.equal(y.detach(), ssd_scan_plain(*_ssd_inputs(False), 8)[0])
    with pytest.raises(NotImplementedError, match="ssd_impl='chunked'"):
        y.sum().backward()
    yb = ssd_scan_bh(x[:, :, 0], a[:, :, 0], B[:, :, 0], C[:, :, 0], chunk=8)
    with pytest.raises(NotImplementedError, match="ssd_impl='chunked'"):
        yb.sum().backward()


def test_forward_only_calls_are_unchanged():
    """No gradient to record (no_grad, or inputs that need none): the plain
    call, with no graph node."""
    for fn, inputs in ((lambda *t: flash_attention_gqa(*t), _qkv),
                       (lambda *t: ssd_scan(*t, chunk=8), _ssd_inputs)):
        plain = fn(*inputs(False))
        assert plain.grad_fn is None
        with torch.no_grad():
            out = fn(*inputs(True))
        assert out.grad_fn is None and torch.equal(out, plain)


@pytest.mark.parametrize("arch,impl", [("qwen3-1.7b", dict(attention_impl="pallas")),
                                       ("mamba2-2.7b", dict(ssd_impl="pallas")),
                                       ("zamba2-2.7b", dict(attention_impl="pallas")),
                                       ("zamba2-2.7b", dict(ssd_impl="pallas")),
                                       ("moonshot-v1-16b-a3b", dict(attention_impl="pallas")),
                                       ("deepseek-v3-671b", dict(attention_impl="pallas")),
                                       ("llama-3.2-vision-90b", dict(attention_impl="pallas")),
                                       ("hubert-xlarge", dict(attention_impl="pallas"))])
def test_a_model_on_the_kernels_cannot_train(arch, impl):
    _, _, tm = _model_pair(arch, **impl)
    params = tm.param_tree()
    step = make_train_step(tm, adamw())
    with pytest.raises(NotImplementedError, match="no backward"):
        step(params, adamw().init(params),
             {k: torch.from_numpy(v) for k, v in _batch(tm.cfg).items()}, 0)


# -- the examples that train -------------------------------------------------------------------


@pytest.mark.parametrize("argv", [
    ["examples/torch_train_lm.py", "--device", "cpu", "--steps", "2", "--batch", "2",
     "--seq", "16"],
    ["examples/torch_quickstart.py", "--device", "cpu", "--lm-steps", "3"],
], ids=["torch_train_lm", "torch_quickstart"])
def test_training_examples_run(argv):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, os.path.join(ROOT, argv[0]), *argv[1:]], cwd=ROOT,
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "loss" in proc.stdout and "→" in proc.stdout
