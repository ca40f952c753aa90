"""The port's LM serving path against repro on the same weights and inputs.

Weights come from repro's ``init`` and are carried across by
``load_jax_params``; inputs are numpy draws.  JAX runs its ``"pallas"``
implementations in interpret mode where a test names them, the port its
plain versions on the CPU.  Modules are held to rtol/atol 1e-5, whole
models' logits to 1e-4.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import ffn as jffn  # noqa: E402
from repro.models import mamba as jmamba  # noqa: E402
from repro.models.build import build_model as jax_build_model  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch.steps import make_decode_step, make_prefill_step  # noqa: E402
from repro_torch.models import attention, common, ffn, mamba  # noqa: E402
from repro_torch.models import build_model, load_jax_params  # noqa: E402
from repro_torch.models.common import params  # noqa: E402

MODULE_TOL = dict(rtol=1e-5, atol=1e-5)
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)
SERVED = {"qwen3-1.7b": dict(attention_impl="pallas"),
          "mamba2-2.7b": dict(ssd_impl="pallas"),
          "zamba2-2.7b": dict(attention_impl="pallas", ssd_impl="pallas"),
          "moonshot-v1-16b-a3b": dict(attention_impl="pallas"),
          "deepseek-v3-671b": dict(attention_impl="pallas")}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs files in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _perturbed(tree, seed):
    """``tree`` with every leaf replaced by a numpy draw of its shape: biases
    and norm scales leave their zeros/ones, so the test sees them."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: (np.asarray(a) + 0.1 * rng.normal(size=a.shape))
                        .astype(np.float32), tree)


def _torch_params(tree) -> torch.nn.ParameterDict:
    return params({k: torch.from_numpy(np.array(v)) for k, v in tree.items()})


def _x(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


# -- common ---------------------------------------------------------------------


def test_rms_norm_and_layer_norm_vs_repro():
    x, scale, bias = _x((2, 5, 16)), _x((16,), 1), _x((16,), 2)
    np.testing.assert_allclose(
        common.rms_norm(torch.from_numpy(x), torch.from_numpy(scale)).numpy(),
        np.asarray(jcommon.rms_norm(jnp.asarray(x), jnp.asarray(scale))), **MODULE_TOL)
    np.testing.assert_allclose(
        common.layer_norm(*map(torch.from_numpy, (x, scale, bias))).numpy(),
        np.asarray(jcommon.layer_norm(*map(jnp.asarray, (x, scale, bias)))), **MODULE_TOL)


@pytest.mark.parametrize("theta", [10000.0, 1000000.0])
def test_apply_rope_vs_repro(theta):
    x = _x((2, 12, 3, 16))
    pos = np.arange(12, dtype=np.int32)[None].repeat(2, 0) + np.array([[0], [7]], np.int32)
    np.testing.assert_allclose(
        common.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta).numpy(),
        np.asarray(jcommon.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)), **MODULE_TOL)


# -- attention -------------------------------------------------------------------


def _gqa_pair(impl):
    kw = dict(d_model=32, n_heads=4, n_kv_heads=2, head_dim=8, qk_norm=True,
              qkv_bias=True, rope_theta=10000.0, attention_impl=impl, block_k=8)
    jp = _perturbed(jattn.init_gqa(jax.random.PRNGKey(0), jattn.GQAConfig(**kw)), 1)
    return jattn.GQAConfig(**kw), attention.GQAConfig(**kw), jp


@pytest.mark.parametrize("impl", ["naive", "blocked", "pallas"])
def test_gqa_attend_vs_repro(impl):
    jcfg, tcfg, jp = _gqa_pair(impl)
    x = _x((2, 20, 32), 3)
    ref = jax.jit(jattn.gqa_attend, static_argnums=2)(jp, jnp.asarray(x), jcfg)
    out = attention.gqa_attend(_torch_params(jp), torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **MODULE_TOL)


def test_gqa_decode_vs_repro():
    jcfg, tcfg, jp = _gqa_pair("naive")
    tp = _torch_params(jp)
    jdecode = jax.jit(jattn.gqa_decode, static_argnums=3)
    jcache = jattn.init_gqa_cache(jcfg, 2, 8, dtype=jnp.float32)
    tcache = attention.init_gqa_cache(tcfg, 2, 8, dtype=torch.float32)
    for pos in range(6):
        x = _x((2, 1, 32), 10 + pos)
        jcache, jy = jdecode(jp, jcache, jnp.asarray(x), jcfg, pos)
        tcache, ty = attention.gqa_decode(tp, tcache, torch.from_numpy(x), tcfg, pos)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **MODULE_TOL)
    np.testing.assert_allclose(tcache.k.numpy(), np.asarray(jcache.k), **MODULE_TOL)
    np.testing.assert_allclose(tcache.v.numpy(), np.asarray(jcache.v), **MODULE_TOL)


# -- ffn -------------------------------------------------------------------------


@pytest.mark.parametrize("kind,bias", [("swiglu", False), ("gelu", True)])
def test_dense_ffn_vs_repro(kind, bias):
    jp = _perturbed(jffn.init_dense_ffn(jax.random.PRNGKey(1), 16, 40, kind=kind, bias=bias), 2)
    x = _x((3, 4, 16), 4)
    ref = jax.jit(jffn.dense_ffn, static_argnames="kind")(jp, jnp.asarray(x), kind=kind)
    out = ffn.dense_ffn(_torch_params(jp), torch.from_numpy(x), kind=kind)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **MODULE_TOL)


# -- mamba -----------------------------------------------------------------------


def _ssm_pair(impl="chunked"):
    kw = dict(d_model=16, d_state=8, head_dim=8, expand=2, n_groups=2, chunk=8, ssd_impl=impl)
    jp = jmamba.init_mamba2(jax.random.PRNGKey(2), jmamba.SSMConfig(**kw))
    jp = dict(_np_tree(jp), conv_b=_x((64,), 5) * 0.1, norm=1.0 + 0.1 * _x((32,), 6),
              dt_bias=0.1 * _x((4,), 7))
    return jmamba.SSMConfig(**kw), mamba.SSMConfig(**kw), jp


@pytest.mark.parametrize("impl", ["chunked", "pallas"])
def test_mamba2_forward_vs_repro(impl):
    jcfg, tcfg, jp = _ssm_pair(impl)
    x = _x((2, 24, 16), 8)
    ref = jax.jit(jmamba.mamba2_forward, static_argnums=2)(jp, jnp.asarray(x), jcfg)
    out = mamba.mamba2_forward(_torch_params(jp), torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **MODULE_TOL)


def test_mamba2_decode_vs_repro():
    jcfg, tcfg, jp = _ssm_pair()
    tp = _torch_params(jp)
    jdecode = jax.jit(jmamba.mamba2_decode, static_argnums=3)
    jcache = jmamba.init_mamba_cache(jcfg, 2)
    tcache = mamba.init_mamba_cache(tcfg, 2)
    for t in range(5):
        x = _x((2, 1, 16), 20 + t)
        jcache, jy = jdecode(jp, jcache, jnp.asarray(x), jcfg)
        tcache, ty = mamba.mamba2_decode(tp, tcache, torch.from_numpy(x), tcfg)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **MODULE_TOL)
    np.testing.assert_allclose(tcache.ssm.numpy(), np.asarray(jcache.ssm), **MODULE_TOL)
    np.testing.assert_allclose(tcache.conv.numpy(), np.asarray(jcache.conv), **MODULE_TOL)


def test_mamba2_forward_needs_whole_chunks():
    _, tcfg, jp = _ssm_pair()
    with pytest.raises(ValueError, match="T % chunk"):
        mamba.mamba2_forward(_torch_params(jp), torch.zeros(1, 12, 16), tcfg)


# -- whole models --------------------------------------------------------------------


def _model_pair(arch, **overrides):
    jcfg = jconfigs.smoke_config(jconfigs.get_arch(arch)).replace(**overrides)
    tcfg = configs.smoke_config(configs.get_arch(arch)).replace(**overrides)
    jm = jax_build_model(jcfg)
    jp = _np_tree(jm.init(jax.random.PRNGKey(0)))
    tm = load_jax_params(build_model(tcfg, device="cpu"), jp)
    return jm, jp, tm


def _tokens(shape, vocab, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, size=shape).astype(np.int32)


@pytest.mark.parametrize("arch,overrides", list(SERVED.items()) + [
    ("starcoder2-3b", dict(attention_impl="naive")),
    ("qwen3-1.7b", dict(attention_impl="blocked", prefill_last_only=True))])
def test_forward_vs_repro(arch, overrides):
    """Prefill logits: JAX on its kernels in interpret mode, the port on their
    plain versions (starcoder2 adds LayerNorm, GELU and biases)."""
    jm, jp, tm = _model_pair(arch, **overrides)
    toks = _tokens((2, 16), tm.cfg.vocab)
    ref = jax.jit(jm.forward)(jp, {"tokens": jnp.asarray(toks)})
    out = make_prefill_step(tm)({"tokens": torch.from_numpy(toks)})
    assert out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **MODEL_TOL)


@pytest.mark.parametrize("arch", list(SERVED))
def test_decode_logits_vs_repro(arch):
    """Logits of every decode step over a prompt and its greedy continuation."""
    jm, jp, tm = _model_pair(arch)
    B, prompt_len, gen = 2, 6, 5
    prompt = _tokens((B, prompt_len), tm.cfg.vocab, seed=1)
    jdecode = jax.jit(jm.decode_step)
    tdecode = make_decode_step(tm)
    jcache, tcache = jm.init_cache(B, prompt_len + gen), tm.init_cache(B, prompt_len + gen)
    tok = prompt[:, :1]
    for pos in range(prompt_len + gen):
        jl, jcache = jdecode(jp, jcache, jnp.asarray(tok), pos)
        tl, tcache = tdecode({"cache": tcache, "tokens": torch.from_numpy(tok), "pos": pos})
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **MODEL_TOL)
        tok = (prompt[:, pos + 1:pos + 2] if pos + 1 < prompt_len
               else np.asarray(jl[:, -1].argmax(-1))[:, None].astype(np.int32))


@pytest.mark.parametrize("arch", list(SERVED) + ["llama-3.2-vision-90b"])
def test_serve_tokens_match_repro(arch, monkeypatch, capsys):
    """The serving schedule: the same prompts (numpy, from the seed), prefill
    by decode, greedy decode — the same tokens as repro's serve when the port
    is given repro's weights for that seed (the vlm with no vision input: its
    zero cross caches, as repro serves it)."""
    seed = 3

    def build_with_jax_weights(cfg, device=None, generator=None):
        jp = _np_tree(jax_build_model(jconfigs.smoke_config(jconfigs.get_arch(arch)))
                      .init(jax.random.PRNGKey(seed)))
        return load_jax_params(build_model(cfg, device=device), jp)

    ref = jserve.serve(arch, smoke=True, batch=2, prompt_len=5, gen=6, seed=seed)
    monkeypatch.setattr(tserve, "build_model", build_with_jax_weights)
    out = tserve.serve(arch, smoke=True, batch=2, prompt_len=5, gen=6, seed=seed, device="cpu")
    assert out.shape == (2, 6)
    np.testing.assert_array_equal(out, np.asarray(ref))
    assert capsys.readouterr().out.count("[serve] prefill 5 toks") == 2


# -- configs, devices and what is deferred ---------------------------------------------


def test_configs_are_repro_configs():
    assert set(configs.ARCHS) == set(jconfigs.ARCHS)
    for name, cfg in configs.ARCHS.items():
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jconfigs.ARCHS[name])
        assert (dataclasses.asdict(configs.smoke_config(cfg))
                == dataclasses.asdict(jconfigs.smoke_config(jconfigs.ARCHS[name])))
    assert {k: dataclasses.astuple(v) for k, v in configs.SHAPES.items()} == \
        {k: dataclasses.astuple(v) for k, v in jconfigs.SHAPES.items()}


def test_entry_points_need_a_gpu_by_default(monkeypatch):
    """device=None means the card: without one, build_model and serve raise."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = configs.smoke_config(configs.get_arch("qwen3-1.7b"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tserve.serve("mamba2-2.7b")


@pytest.mark.parametrize("arch", ["qwen2-72b", "moonshot-v1-16b-a3b"])
def test_int8_decode_logits_vs_repro(arch):
    """kv_cache_dtype="int8" (GQA, and GQA with MoE): every decode step's
    logits as repro's int8 decode, and the caches' codes and scales equal."""
    jm, jp, tm = _model_pair(arch, kv_cache_dtype="int8", attention_impl="naive")
    B, T = 2, 12
    toks = _tokens((B, T), tm.cfg.vocab, seed=5)
    jdecode, tdecode = jax.jit(jm.decode_step), make_decode_step(tm)
    jcache, tcache = jm.init_cache(B, T), tm.init_cache(B, T)
    assert all(isinstance(c, attention.QuantKVCache) for seg in tcache.values() for c in seg)
    for pos in range(T):
        jl, jcache = jdecode(jp, jcache, jnp.asarray(toks[:, pos:pos + 1]), pos)
        tl, tcache = tdecode({"cache": tcache, "tokens": torch.from_numpy(toks[:, pos:pos + 1]),
                              "pos": pos})
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **MODEL_TOL)
    for name, seg in tcache.items():
        for layer, c in enumerate(seg):
            for field, ours, theirs in zip(c._fields, c, jcache[name]):
                np.testing.assert_array_equal(ours.float().numpy(),
                                              np.asarray(theirs[layer], np.float32),
                                              err_msg=f"{name}/{layer}/{field}")


def test_int8_decode_close_to_unquantized():
    """tests/test_archs_smoke.py's int8 check on the port: logits within 0.15
    of the unquantized cache's at every step, the cache int8 underneath."""
    cfg = configs.smoke_config(configs.get_arch("qwen2-72b")).replace(attention_impl="naive")
    m = build_model(cfg, device="cpu")
    mq = build_model(cfg.replace(kv_cache_dtype="int8"), device="cpu")
    mq.load_state_dict(m.state_dict())
    B, T = 2, 12
    toks = torch.from_numpy(_tokens((B, T), cfg.vocab))
    c, cq = m.init_cache(B, T), mq.init_cache(B, T)
    for t in range(T):
        lg, c = m.decode_step(c, toks[:, t:t + 1], t)
        lq, cq = mq.decode_step(cq, toks[:, t:t + 1], t)
        assert float((lg - lq).abs().max()) < 0.15
    assert cq["seg0"][0].k_q.dtype == torch.int8 and cq["seg0"][0].k_q.any()


@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b", "deepseek-v3-671b"])
@pytest.mark.parametrize("groups,capacity", [(2, 1.25), (1, 0.5)])
def test_moe_forward_groups_and_drops_vs_repro(arch, groups, capacity):
    """Routing in data groups (build_model(cfg, data_groups=2), as repro's)
    and a capacity that drops slots: the port drops the same ones."""
    jcfg = jconfigs.smoke_config(jconfigs.get_arch(arch)).replace(capacity_factor=capacity)
    tcfg = configs.smoke_config(configs.get_arch(arch)).replace(capacity_factor=capacity)
    jm = jax_build_model(jcfg, groups)
    jp = _np_tree(jm.init(jax.random.PRNGKey(1)))
    tm = load_jax_params(build_model(tcfg, device="cpu", data_groups=groups), jp)
    assert tm.moe_cfg.data_groups == groups
    toks = _tokens((2, 16), tcfg.vocab, seed=4)
    ref = jax.jit(jm.forward)(jp, {"tokens": jnp.asarray(toks)})
    out = make_prefill_step(tm)({"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **MODEL_TOL)


@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b", "deepseek-v3-671b"])
def test_moe_decode_matches_forward(arch):
    """tests/test_archs_smoke.py's teacher-forced decode on the port: with a
    capacity no token exceeds, the decode steps give the forward's logits
    (the forward drops slots batch-wide, decode routes a step at a time)."""
    cfg = configs.smoke_config(configs.get_arch(arch)).replace(attention_impl="naive",
                                                               capacity_factor=8.0)
    tm = build_model(cfg, device="cpu")
    toks = torch.from_numpy(_tokens((2, 16), cfg.vocab, seed=2))
    full = make_prefill_step(tm)({"tokens": toks})
    cache, step = tm.init_cache(2, 16), make_decode_step(tm)
    outs = []
    for t in range(16):
        logits, cache = step({"cache": cache, "tokens": toks[:, t:t + 1], "pos": t})
        outs.append(logits[:, 0])
    torch.testing.assert_close(torch.stack(outs, 1), full, rtol=2e-3, atol=2e-3)


def test_load_jax_params_checks_names_and_shapes():
    jm, jp, tm = _model_pair("mamba2-2.7b")
    bad = dict(jp, head={"w": np.zeros((3, 3), np.float32)})
    with pytest.raises(ValueError, match="/head/w"):
        load_jax_params(tm, bad)
    with pytest.raises(KeyError, match="final_norm"):
        load_jax_params(tm, {k: v for k, v in jp.items() if k != "final_norm"})


# -- the hybrid family's parameters ------------------------------------------------


def test_hybrid_carries_doubly_stacked_leaves():
    """repro's segments/mamba/<leaf> is (n_super, period, ...): superblock s,
    block i of the port gets [s, i]; the shared block is one unstacked set."""
    jm, jp, tm = _model_pair("zamba2-2.7b")
    cfg = tm.cfg
    n_super, period = cfg.n_layers // cfg.hybrid_period, cfg.hybrid_period
    stacked = jp["segments"]["mamba"]["mamba"]["in_proj"]
    assert stacked.shape[:2] == (n_super, period) and n_super > 1 and period > 1
    for s in range(n_super):
        for i in range(period):
            np.testing.assert_array_equal(
                tm.segments["mamba"][s][i]["mamba"]["in_proj"].detach().numpy(), stacked[s, i])
    np.testing.assert_array_equal(tm.shared_block["attn"]["wq"].detach().numpy(),
                                  jp["shared_block"]["attn"]["wq"])


def test_hybrid_load_rejects_a_wrong_shape():
    jm, jp, tm = _model_pair("zamba2-2.7b")
    bad = jax.tree.map(lambda a: a, jp)
    a_log = np.asarray(bad["segments"]["mamba"]["mamba"]["A_log"])
    bad["segments"]["mamba"]["mamba"]["A_log"] = a_log[..., :-1]
    with pytest.raises(ValueError, match="/segments/mamba/0/0/mamba/A_log"):
        load_jax_params(tm, bad)
    bad = jax.tree.map(lambda a: a, jp)
    bad["shared_block"]["ffn"] = {k: v[:-1] for k, v in jp["shared_block"]["ffn"].items()}
    with pytest.raises(ValueError, match="/shared_block/ffn/"):
        load_jax_params(tm, bad)


@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
def test_hybrid_shares_one_block_and_counts_repros_parameters(smoke):
    """One weight set for the shared block, and as many parameters as
    repro's init (at the full config by jax.eval_shape, no weights made)."""
    jcfg, tcfg = jconfigs.get_arch("zamba2-2.7b"), configs.get_arch("zamba2-2.7b")
    if smoke:
        jcfg, tcfg = jconfigs.smoke_config(jcfg), configs.smoke_config(tcfg)
    shapes = jax.eval_shape(jax_build_model(jcfg).init, jax.random.PRNGKey(0))
    want = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(shapes))
    shared = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(shapes["shared_block"]))
    tm = build_model(tcfg, device="meta", generator=torch.Generator())
    assert sum(p.numel() for p in tm.parameters()) == want
    assert sum(p.numel() for p in tm.shared_block.parameters()) == shared
    names = [n for n in tm.param_tree() if "attn" in n or "ffn" in n]
    assert names and all(n.startswith("shared_block.") for n in names)
    if not smoke:
        assert want == 2_422_670_240 and shared == 104_862_720
