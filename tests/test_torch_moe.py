"""The port's MoE FFN and MLA attention against repro on the same inputs.

Mirrors tests/test_ffn_moe.py (gather against the dense oracle, capacity
drops, the shared expert, the uniform router's aux loss) and
tests/test_attention.py's MLA decode-equals-prefill on the port, then holds
``moe_ffn``, ``mla_attend`` and ``mla_decode`` against repro's with repro's
weights carried across: routed experts and kept slots equal, outputs and
aux within MODULE_TOL in fp32 and 3e-2 in bf16.  Whole moe models (forward,
decode, serve, training) are cases of tests/test_torch_models.py and
tests/test_torch_train.py; this file adds the moe trees' carry and their
parameter counts."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import ffn as jffn  # noqa: E402
from repro.models.build import build_model as jax_build_model  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models import attention, ffn  # noqa: E402
from repro_torch.models import build_model, load_jax_params  # noqa: E402
from repro_torch.models.common import params  # noqa: E402
from repro_torch.models.convert import jax_tree_to_params  # noqa: E402

MODULE_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=3e-2, atol=3e-2)
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
MOE_ARCHS = ["moonshot-v1-16b-a3b", "deepseek-v3-671b"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs files in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _x(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _moe(cfg: ffn.MoEConfig, seed=0, dtype=torch.float32):
    """A port MoE layer with repro's init of ``cfg`` (same fields) carried in,
    and repro's params."""
    jdtype = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    jp = jffn.init_moe(jax.random.PRNGKey(seed), jffn.MoEConfig(**cfg._asdict()), jdtype)
    tp = load_jax_params(ffn.init_moe(cfg, dtype=dtype, generator=torch.Generator()),
                         _np_tree(jp))
    return jp, tp


# -- tests/test_ffn_moe.py on the port --------------------------------------------------


@pytest.mark.parametrize("groups", [1, 2])
def test_moe_gather_matches_dense(groups):
    """With capacity high enough that nothing drops, gather == dense oracle."""
    cfg_g = ffn.MoEConfig(d_model=16, n_experts=4, top_k=2, d_ff_expert=8,
                          capacity_factor=8.0, impl="gather", data_groups=groups)
    _, p = _moe(cfg_g)
    x = torch.from_numpy(_x((2, 8, 16)))
    yg, aux_g = ffn.moe_ffn(p, x, cfg_g)
    yd, aux_d = ffn.moe_ffn(p, x, cfg_g._replace(impl="dense"))
    torch.testing.assert_close(yg, yd, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(aux_g, aux_d, rtol=1e-5, atol=0)


def test_moe_capacity_drops_tokens():
    cfg = ffn.MoEConfig(d_model=8, n_experts=2, top_k=1, d_ff_expert=8,
                        capacity_factor=0.1, impl="gather")  # capacity 1 per expert
    _, p = _moe(cfg, seed=1)
    x = torch.ones((1, 16, 8))
    y, _ = ffn.moe_ffn(p, x, cfg)
    assert y.shape == (1, 16, 8)  # dropped tokens contribute 0, no crash
    loads, C = ffn.expert_loads(p, x, cfg)
    assert C == 1 and int(loads.sum()) == 16
    # every token but one an expert keeps is dropped: its output is exactly 0
    assert int((y.abs().sum(-1) > 0).sum()) == int((loads > 0).sum())


def test_shared_expert_adds():
    cfg0 = ffn.MoEConfig(d_model=8, n_experts=2, top_k=1, d_ff_expert=8,
                         capacity_factor=4.0, impl="dense", n_shared=0)
    cfg1 = cfg0._replace(n_shared=1)
    _, p1 = _moe(cfg1, seed=2)
    p0 = ffn.MoE({k: p1[k].detach() for k in ("router", "w_gate", "w_up", "w_down")}, {})
    x = torch.ones((1, 4, 8))
    y0, _ = ffn.moe_ffn(p0, x, cfg0)
    y1, _ = ffn.moe_ffn(p1, x, cfg1)
    shared_out = ffn.dense_ffn(p1["shared"], x.reshape(4, 8), kind="swiglu").reshape(1, 4, 8)
    torch.testing.assert_close(y1 - y0, shared_out, rtol=1e-4, atol=1e-5)


def test_aux_loss_uniform_router_is_one_weighted():
    """Perfectly balanced routing gives aux ≈ weight·E·Σ(1/E·1/E)·E = weight;
    every probability ties, so the top-1 is expert 0 in both packages."""
    cfg = ffn.MoEConfig(d_model=8, n_experts=4, top_k=1, d_ff_expert=8,
                        impl="dense", aux_loss_weight=1.0)
    jp, p = _moe(cfg, seed=3)
    with torch.no_grad():
        p["router"].zero_()
    x = _x((1, 64, 8))
    _, aux = ffn.moe_ffn(p, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(float(aux), 1.0, rtol=0.15)
    jcfg = jffn.MoEConfig(**cfg._asdict())
    _, jidx, jaux = jffn._router(dict(jp, router=jnp.zeros((8, 4))), jnp.asarray(x[0]), jcfg)
    _, idx, _ = ffn._router(p, torch.from_numpy(x[0]), cfg)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    assert not idx.any()
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)


def test_top_k_breaks_ties_to_the_lower_index():
    probs = torch.tensor([[0.1, 0.3, 0.3, 0.3], [0.25, 0.25, 0.25, 0.25]])
    vals, idx = ffn._top_k(probs, 3)
    jvals, jidx = jax.lax.top_k(jnp.asarray(probs.numpy()), 3)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))


# -- moe_ffn against repro -----------------------------------------------------------------


def _repro_keep(idx, cfg, T):
    """repro's ``_moe_gather`` dispatch lines on its routed experts: each
    sorted slot's expert, source token, clipped position and keep mask."""
    E, k, G = cfg.n_experts, cfg.top_k, max(1, cfg.data_groups)
    Tg = T // G
    C = max(1, int(np.ceil(k * Tg / E * cfg.capacity_factor)))
    eid = idx.reshape(G, Tg * k)
    order = jnp.argsort(eid, axis=-1)
    eid_s = jnp.take_along_axis(eid, order, axis=-1)
    counts = jax.vmap(lambda e: jnp.bincount(e, length=E))(eid)
    offs = jnp.cumsum(counts, axis=-1) - counts
    pos = jnp.arange(Tg * k)[None, :] - jnp.take_along_axis(offs, eid_s, axis=-1)
    return [np.asarray(a) for a in (eid_s, order // k, jnp.clip(pos, 0, C - 1), pos < C)], C


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("n_shared", [0, 1])
@pytest.mark.parametrize("capacity", [0.1, 1.25, 8.0])
@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("impl", ["gather", "dense"])
def test_moe_ffn_vs_repro(impl, groups, capacity, n_shared, dtype):
    jdt, tdt = DTYPES[dtype]
    cfg = ffn.MoEConfig(d_model=16, n_experts=8, top_k=2, d_ff_expert=12, n_shared=n_shared,
                        capacity_factor=capacity, impl=impl, data_groups=groups)
    jcfg = jffn.MoEConfig(**cfg._asdict())
    jp, p = _moe(cfg, seed=5, dtype=tdt)
    x = _x((2, 12, 16), 6)
    jx, tx = jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)
    jy, jaux = jax.jit(jffn.moe_ffn, static_argnums=2)(jp, jx, jcfg)
    y, aux = ffn.moe_ffn(p, tx, cfg)
    assert y.dtype == tdt and y.shape == (2, 12, 16)
    # the same experts routed, and the same slots kept and dropped
    _, jidx, _ = jffn._router(jp, jx.reshape(24, 16), jcfg)
    _, idx, _ = ffn._router(p, tx.reshape(24, 16), cfg)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    want, C = _repro_keep(jidx, jcfg, 24)
    order, *got = ffn._slots(idx, cfg, ffn.capacity(cfg, 24))
    assert ffn.capacity(cfg, 24) == C
    got = [got[0], order // cfg.top_k, *got[1:]]
    for name, a, b in zip(("expert", "token", "position", "keep"), got, want):
        np.testing.assert_array_equal(a.numpy(), b, err_msg=name)
    if capacity == 0.1 and impl == "gather":
        assert not want[3].all()            # this case drops slots
    tol = MODULE_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(y.float().numpy(), np.asarray(jy, np.float32), **tol)
    np.testing.assert_allclose(float(aux), float(jaux), **MODULE_TOL)


def test_moe_gather_is_differentiable_like_repros():
    """Gradients of the gather path (through the dispatch's gathers and the
    buffer's index_put) to x and every weight, against jax.grad's."""
    cfg = ffn.MoEConfig(d_model=16, n_experts=8, top_k=2, d_ff_expert=12, n_shared=1,
                        capacity_factor=1.0, data_groups=2)
    jcfg = jffn.MoEConfig(**cfg._asdict())
    jp, p = _moe(cfg, seed=7)
    x = _x((2, 12, 16), 8)

    def jloss(params, xx):
        y, aux = jffn.moe_ffn(params, xx, jcfg)
        return jnp.sum(y * jnp.asarray(_x((2, 12, 16), 9))) + aux

    jg, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    p.requires_grad_(True)
    tx = torch.from_numpy(x).requires_grad_(True)
    y, aux = ffn.moe_ffn(p, tx, cfg)
    (torch.sum(y * torch.from_numpy(_x((2, 12, 16), 9))) + aux).backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), **MODULE_TOL)
    want = jax_tree_to_params(p, _np_tree(jg))
    for name, t in p.named_parameters():
        np.testing.assert_allclose(t.grad.numpy(), want[name].numpy(), rtol=1e-4, atol=1e-5,
                                   err_msg=name)


def test_moe_ep_runs():
    """moe_impl="ep" runs over the registered mesh: the layer against the
    dense oracle where nothing drops, and a whole deepseek smoke model
    (MLA + MoE + MTP) whose forward equals its gather path's (4 data groups
    on a (4, 2) mesh route alike) and whose decode keeps the gather path.
    repro's EP itself is held against in tests/test_torch_ep.py."""
    from repro_torch.launch import make_host_mesh, shardings as sh
    saved = (dict(sh._AXIS_SIZES), sh.CURRENT_MESH)
    try:
        sh.set_mesh_axis_sizes(make_host_mesh(data=4, model=2, device="cpu"))
        cfg = ffn.MoEConfig(d_model=8, n_experts=2, top_k=1, d_ff_expert=8, impl="ep",
                            capacity_factor=4.0)
        _, p = _moe(cfg._replace(impl="gather"))
        x = torch.from_numpy(_x((4, 4, 8)))
        y, _ = ffn.moe_ffn(p, x, cfg)
        yd, _ = ffn.moe_ffn(p, x, cfg._replace(impl="dense"))
        torch.testing.assert_close(y, yd, rtol=1e-5, atol=1e-6)
        tcfg = configs.smoke_config(configs.get_arch("deepseek-v3-671b")).replace(
            capacity_factor=8.0)
        ep = build_model(tcfg.replace(moe_impl="ep"), device="cpu", data_groups=4)
        gather = build_model(tcfg, device="cpu", data_groups=4)
        tokens = torch.randint(0, tcfg.vocab, (4, 8), generator=torch.Generator().manual_seed(0))
        torch.testing.assert_close(ep.forward({"tokens": tokens}),
                                   gather.forward({"tokens": tokens}), rtol=1e-5, atol=1e-5)
        sh.CURRENT_MESH = None              # decode routes by the gather path: no mesh
        logits, _ = ep.decode_step(ep.init_cache(4, 8), tokens[:, :1], 0)
        assert logits.shape == (4, 1, tcfg.vocab)
    finally:
        sh._AXIS_SIZES, sh.CURRENT_MESH = saved


# -- MLA ------------------------------------------------------------------------------------


def _mla_pair(impl="naive", dtype="float32", seed=0):
    kw = dict(d_model=32, n_heads=2, q_lora_rank=16, kv_lora_rank=8, qk_nope_dim=8,
              qk_rope_dim=4, v_head_dim=8, attention_impl=impl, block_k=8)
    jdt, tdt = DTYPES[dtype]
    jp = jattn.init_mla(jax.random.PRNGKey(seed), jattn.MLAConfig(**kw), jdt)
    rng = np.random.default_rng(seed + 1)
    # norm scales off their ones, so the test sees them
    jp = dict(jp, q_norm=(1 + 0.1 * rng.normal(size=16)).astype(jdt),
              kv_norm=(1 + 0.1 * rng.normal(size=8)).astype(jdt))
    tp = params({k: torch.from_numpy(np.asarray(v, np.float32)).to(tdt) for k, v in jp.items()})
    return jattn.MLAConfig(**kw), attention.MLAConfig(**kw), jp, tp


@pytest.mark.parametrize("impl", ["naive", "blocked", "pallas"])
def test_mla_attend_vs_repro(impl):
    """dk = nope 8 + rope 4 = 12 against dv 8, as deepseek's 192 against
    128 (pallas: the flash kernel's plain version on the CPU)."""
    jcfg, tcfg, jp, tp = _mla_pair(impl)
    x = _x((2, 20, 32), 3)
    ref = jax.jit(jattn.mla_attend, static_argnums=2)(jp, jnp.asarray(x), jcfg)
    out = attention.mla_attend(tp, torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **MODULE_TOL)


def test_mla_attend_dk_differs_from_dv():
    """At dk = dn + dr != dv the three implementations agree (pallas: the
    kernel's plain version on the CPU)."""
    kw = dict(d_model=32, n_heads=3, q_lora_rank=16, kv_lora_rank=8, qk_nope_dim=16,
              qk_rope_dim=8, v_head_dim=8, block_k=8)
    p = attention.init_mla(attention.MLAConfig(**kw), generator=torch.Generator().manual_seed(0))
    x = torch.from_numpy(_x((2, 19, 32), 4))
    outs = {impl: attention.mla_attend(p, x, attention.MLAConfig(**kw, attention_impl=impl))
            for impl in ("naive", "blocked", "pallas")}
    for impl in ("blocked", "pallas"):
        torch.testing.assert_close(outs[impl], outs["naive"], **MODULE_TOL)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_mla_decode_vs_repro(dtype):
    """The absorbed decode step by step, and the compressed cache, against
    repro's (bf16: its dtype sequence, q_c in bf16 then fp32 scores, o_c
    cast back to bf16 before w_uv)."""
    jcfg, tcfg, jp, tp = _mla_pair(dtype=dtype)
    jdt, tdt = DTYPES[dtype]
    tol = MODULE_TOL if dtype == "float32" else BF16_TOL
    jdecode = jax.jit(jattn.mla_decode, static_argnums=3)
    jcache = jattn.init_mla_cache(jcfg, 2, 8, dtype=jdt)
    tcache = attention.init_mla_cache(tcfg, 2, 8, dtype=tdt)
    for pos in range(7):
        x = _x((2, 1, 32), 10 + pos)
        jcache, jy = jdecode(jp, jcache, jnp.asarray(x, jdt), jcfg, pos)
        same, ty = attention.mla_decode(tp, tcache, torch.from_numpy(x).to(tdt), tcfg, pos)
        assert same is tcache                      # updated in place
        assert ty.dtype == tdt
        np.testing.assert_allclose(ty.float().numpy(), np.asarray(jy, np.float32), **tol)
    for name in ("c_kv", "k_rope"):
        np.testing.assert_allclose(getattr(tcache, name).float().numpy(),
                                   np.asarray(getattr(jcache, name), np.float32), **tol,
                                   err_msg=name)


def test_mla_decode_matches_prefill_last_token():
    """tests/test_attention.py's check on the port: absorbed-matrix decode ==
    expand-everything attention, token by token."""
    kw = dict(d_model=32, n_heads=2, q_lora_rank=16, kv_lora_rank=8, qk_nope_dim=8,
              qk_rope_dim=4, v_head_dim=8, attention_impl="naive")
    cfg = attention.MLAConfig(**kw)
    p = attention.init_mla(cfg, generator=torch.Generator().manual_seed(0))
    B, T = 2, 6
    x = torch.from_numpy(_x((B, T, 32), 3))
    full = attention.mla_attend(p, x, cfg)
    cache = attention.init_mla_cache(cfg, B, T, torch.float32)
    for t in range(T):
        cache, out = attention.mla_decode(p, cache, x[:, t:t + 1], cfg, t)
        torch.testing.assert_close(out[:, 0], full[:, t], rtol=2e-4, atol=2e-4)


# -- the moe family's parameter trees ---------------------------------------------------------


def _model_pair(arch):
    jcfg = jconfigs.smoke_config(jconfigs.get_arch(arch))
    jp = _np_tree(jax_build_model(jcfg).init(jax.random.PRNGKey(0)))
    tm = load_jax_params(build_model(configs.smoke_config(configs.get_arch(arch)),
                                     device="cpu"), jp)
    return jp, tm


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_tree_carries_leaves_beside_subtrees(arch):
    """An MoE layer holds leaves (router, w_*) beside a sub-tree (shared);
    deepseek's MTP holds proj beside its block and norms.  load_jax_params
    carries both, jax_tree_to_params finds them by dotted name, and a
    missing or extra name on either side is refused."""
    jp, tm = _model_pair(arch)
    moe = jp["segments"]["seg1"]["moe"]
    np.testing.assert_array_equal(tm.segments["seg1"][0]["moe"]["router"].numpy(),
                                  moe["router"][0])
    np.testing.assert_array_equal(tm.segments["seg1"][0]["moe"]["shared"]["w_up"].numpy(),
                                  moe["shared"]["w_up"][0])
    tree = jax_tree_to_params(tm, jp)
    assert tree.keys() == tm.param_tree().keys()
    for name, p in tm.param_tree().items():
        assert torch.equal(tree[name], p.detach().float()), name
    assert "segments.seg1.0.moe.router" in tree
    assert "segments.seg1.0.moe.shared.w_down" in tree
    if tm.cfg.mtp:
        assert "mtp.proj" in tree and "mtp.block.ffn.w_gate" in tree
        np.testing.assert_array_equal(tm.mtp["proj"].numpy(), jp["mtp"]["proj"])
        bad = jax.tree.map(lambda a: a, jp)
        bad["mtp"] = {k: v for k, v in jp["mtp"].items() if k != "proj"}
        with pytest.raises(KeyError, match="/mtp"):
            load_jax_params(tm, bad)
    bad = jax.tree.map(lambda a: a, jp)
    bad["segments"]["seg1"]["moe"] = dict(moe, extra=moe["router"])
    with pytest.raises(KeyError, match="extra"):
        load_jax_params(tm, bad)
    bad["segments"]["seg1"]["moe"] = dict(moe, router=moe["router"][..., :-1])
    with pytest.raises(ValueError, match="/segments/seg1/0/moe/router"):
        load_jax_params(tm, bad)


@pytest.mark.parametrize("arch,n_layers,want", [
    ("moonshot-v1-16b-a3b", None, None),
    ("deepseek-v3-671b", None, None),
    ("moonshot-v1-16b-a3b", 48, 28_386_592_768),
    ("moonshot-v1-16b-a3b", 24, 14_277_904_384),
    ("deepseek-v3-671b", 4, 15_797_366_784),
    ("deepseek-v3-671b", 61, None),
], ids=["moonshot-smoke", "deepseek-smoke", "moonshot-48", "moonshot-24", "deepseek-4",
        "deepseek-61"])
def test_moe_parameter_counts_are_repros(arch, n_layers, want):
    """As many parameters as repro's init, by name and shape (at the full
    widths by jax.eval_shape against a device="meta" build: no weights are
    made); the router stays fp32 in a bf16 model."""
    jcfg, tcfg = jconfigs.get_arch(arch), configs.get_arch(arch)
    if n_layers is None:
        jcfg, tcfg = jconfigs.smoke_config(jcfg), configs.smoke_config(tcfg)
    else:
        jcfg, tcfg = jcfg.replace(n_layers=n_layers), tcfg.replace(n_layers=n_layers)
    shapes = jax.eval_shape(jax_build_model(jcfg).init, jax.random.PRNGKey(0))
    tm = build_model(tcfg.replace(dtype="bfloat16"), device="meta", generator=torch.Generator())
    got = {n: tuple(p.shape) for n, p in tm.named_parameters()}
    leaves = jax.tree_util.tree_flatten_with_path(shapes)[0]
    jshapes = {"/".join(k.key for k in path): tuple(a.shape) for path, a in leaves}
    ours = {}                             # repro's leaf -> (port tensors, layer axes)
    for name, shape in got.items():
        parts = name.split(".")
        layers = sum(part.isdigit() for part in parts)
        key = "/".join(part for part in parts if not part.isdigit())
        assert jshapes[key][layers:] == shape, name
        ours[key] = (ours.get(key, (0, layers))[0] + 1, layers)
    assert ours.keys() == jshapes.keys()
    for key, (n, layers) in ours.items():  # one port tensor per stacked layer
        assert n == int(np.prod(jshapes[key][:layers])), key
    assert sum(int(np.prod(a.shape)) for _, a in leaves) == sum(p.numel() for p in
                                                               tm.parameters())
    for name, p in tm.named_parameters():
        assert p.dtype == (torch.float32 if name.endswith(".router") else torch.bfloat16), name
    if want is not None:
        assert sum(p.numel() for p in tm.parameters()) == want
