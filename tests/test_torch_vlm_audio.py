"""The int8 KV cache, the vlm family (llama-3.2-vision, cross-attention) and
the audio family (hubert) against repro on the CPU.

Weights come from repro's ``init`` and are carried across by
``load_jax_params``; inputs are numpy draws.  The quantizer's codes and
scales are bit-equal to repro's; modules are held to rtol/atol 1e-5, whole
models' logits to 1e-4, losses to 1e-5 relative and every gradient leaf to
1e-4 of its max |g|.  repro's vlm decode never fills its cross caches
(``init_cache`` makes zeros and ``decode_step`` passes them through), so
the decode tests run it twice: on those zeros, and on cross caches the test
fills with the vision K/V that ``cross_attend`` computes (the same numbers
written into both packages' caches)."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.launch.train import batch_for as j_batch_for  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models.build import build_model as jax_build_model  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.data import lm_batch  # noqa: E402
from repro_torch.launch.steps import make_decode_step, make_prefill_step  # noqa: E402
from repro_torch.launch.train import batch_for  # noqa: E402
from repro_torch.models import attention, build_model, load_jax_params  # noqa: E402
from repro_torch.models.common import params, rms_norm  # noqa: E402
from repro_torch.models.convert import jax_tree_to_params  # noqa: E402

MODULE_TOL = dict(rtol=1e-5, atol=1e-5)
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)
VLM, AUDIO = "llama-3.2-vision-90b", "hubert-xlarge"


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
    jm = jax_build_model(jcfg)
    jp = _np_tree(jm.init(jax.random.PRNGKey(seed)))
    tm = load_jax_params(build_model(tcfg, device="cpu"), jp)
    return jm, jp, tm


def _batch(cfg, B=2, T=16, seed=0):
    """tests/test_archs_smoke.py's batch: numpy draws of the family's inputs."""
    rng = np.random.default_rng(seed)
    if cfg.family == "audio":
        return {"frames": rng.normal(size=(B, T, cfg.frame_dim)).astype(np.float32),
                "labels": rng.integers(0, cfg.vocab, size=(B, T)).astype(np.int32)}
    b = {"tokens": rng.integers(0, cfg.vocab, size=(B, T)).astype(np.int32),
         "labels": rng.integers(0, cfg.vocab, size=(B, T)).astype(np.int32)}
    if cfg.family == "vlm":
        b["vision_embeds"] = rng.normal(
            size=(B, cfg.vision_tokens, cfg.vision_dim)).astype(np.float32)
    return b


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _grads(tm, batch):
    tm.requires_grad_(True)
    tree = tm.param_tree()
    loss, metrics = tm.loss_fn(_torch(batch))
    return loss, metrics, dict(zip(tree, torch.autograd.grad(loss, list(tree.values()))))


# -- the int8 quantizer -------------------------------------------------------------------


def test_quantize_i8_is_bit_equal_to_repros():
    """Codes, bf16 scales and their dequantization equal repro's, bit for
    bit: random rows at scales from 1e-6 to 1e3 (fp32 and bf16 inputs), an
    all-zero row (the 1e-8 floor), a row whose max is exactly at the clip."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 40, 4, 16)) * 10.0 ** rng.uniform(-6, 3, size=(3, 40, 4, 1))
    x = x.astype(np.float32)
    x[0, 0, 0] = 0.0
    x[0, 1, 0] = np.linspace(-127.0, 127.0, 16, dtype=np.float32)
    for dtype, jdtype in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        xt = torch.from_numpy(x).to(dtype)
        q, s = attention._quantize_i8(xt)
        jq, js = jattn._quantize_i8(jnp.asarray(x, jdtype))
        assert q.dtype == torch.int8 and s.dtype == torch.bfloat16 and s.shape == (3, 40, 4, 1)
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(s.float().numpy(), np.asarray(js, np.float32))
        np.testing.assert_array_equal(attention._dequantize_i8(q, s).numpy(),
                                      np.asarray(jattn._dequantize_i8(jq, js)))
    assert not q[0, 0, 0].any() and float(s[0, 0, 0]) == float(torch.tensor(1e-8).bfloat16())
    assert q[0, 1, 0].abs().max() == 127 and {int(q[0, 1, 0, 0]), int(q[0, 1, 0, -1])} == {-127, 127}


def test_gqa_decode_on_the_int8_cache_vs_repro():
    """One layer's int8 decode: the outputs within 1e-5 and the cache's codes
    and scales equal to repro's after every step."""
    kw = dict(d_model=32, n_heads=4, n_kv_heads=2, head_dim=8, qk_norm=True,
              rope_theta=10000.0, attention_impl="naive")
    jcfg, tcfg = jattn.GQAConfig(**kw), attention.GQAConfig(**kw)
    jp = _np_tree(jattn.init_gqa(jax.random.PRNGKey(0), jcfg))
    tp = params({k: torch.from_numpy(np.array(v)) for k, v in jp.items()})
    jcache = jattn.init_gqa_cache(jcfg, 2, 8, quantized=True)
    tcache = attention.init_gqa_cache(tcfg, 2, 8, quantized=True)
    assert isinstance(tcache, attention.QuantKVCache)
    jdecode = jax.jit(jattn.gqa_decode, static_argnums=3)
    rng = np.random.default_rng(1)
    for pos in range(6):
        x = rng.normal(size=(2, 1, 32)).astype(np.float32)
        jcache, jy = jdecode(jp, jcache, jnp.asarray(x), jcfg, pos)
        tcache, ty = attention.gqa_decode(tp, tcache, torch.from_numpy(x), tcfg, pos)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **MODULE_TOL)
        for name, ours, theirs in zip(tcache._fields, tcache, jcache):
            np.testing.assert_array_equal(ours.float().numpy(), np.asarray(theirs, np.float32),
                                          err_msg=name)


@pytest.mark.parametrize("arch", ["deepseek-v3-671b", "zamba2-2.7b", VLM])
def test_int8_cache_is_ignored_where_repro_ignores_it(arch):
    """MLA, the hybrid's shared block and the vlm keep their caches under
    kv_cache_dtype="int8", as repro's do: no int8 leaf in either package."""
    jcfg = jconfigs.smoke_config(jconfigs.get_arch(arch)).replace(kv_cache_dtype="int8")
    tcfg = configs.smoke_config(configs.get_arch(arch)).replace(kv_cache_dtype="int8")
    jcache = jax_build_model(jcfg).init_cache(2, 8)
    tcache = build_model(tcfg, device="cpu").init_cache(2, 8)
    leaves = [t for t in jax.tree.leaves(tcache, is_leaf=torch.is_tensor)]
    assert leaves and all(t.dtype == torch.float32 for t in leaves)
    assert all(a.dtype == jnp.float32 for a in jax.tree.leaves(jcache))


# -- the vlm family ---------------------------------------------------------------------------


@pytest.mark.parametrize("impl", ["naive", "blocked"])
def test_vlm_forward_vs_repro(impl):
    jm, jp, tm = _model_pair(VLM, attention_impl=impl)
    batch = _batch(tm.cfg)
    batch.pop("labels")
    ref = jax.jit(jm.forward)(jp, _jax(batch))
    out = make_prefill_step(tm)(_torch(batch))
    assert out.shape == ref.shape == (2, 16, tm.cfg.vocab)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **MODEL_TOL)


def test_vlm_loss_and_grads_vs_repro():
    """Every gradient leaf, vision_proj's and the cross blocks' included, on
    naive attention (blocked attention's, in four variants, are cases of
    test_torch_train.py)."""
    jm, jp, tm = _model_pair(VLM, attention_impl="naive")
    batch = _batch(tm.cfg)
    loss, metrics, grads = _grads(tm, batch)
    (jloss, jmetrics), jgrads = jax.jit(jax.value_and_grad(jm.loss_fn, has_aux=True))(
        jp, _jax(batch))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    assert set(metrics) == set(jmetrics) == {"ce", "aux"}
    want = jax_tree_to_params(tm, _np_tree(jgrads))
    assert want.keys() == grads.keys() and "vision_proj.w" in grads
    for name, g in grads.items():
        bound = 1e-4 * max(float(want[name].abs().max()), 1e-30)
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), rtol=0, atol=bound,
                                   err_msg=name)
    assert float(grads["vision_proj.w"].abs().max()) > 0


def _cross_kv(tm, vision_embeds):
    """Each cross block's vision K/V as ``cross_attend`` computes them (k-norm
    where the config sets it): [(k, v)] * n_super, numpy."""
    with torch.no_grad():
        vis = tm._vision_of({"vision_embeds": torch.from_numpy(vision_embeds)})
        out = []
        for sblk in tm.segments["seg0"]:
            p = sblk["cross"]["attn"]
            k = torch.einsum("bsd,dhk->bshk", vis, p["wk"])
            v = torch.einsum("bsd,dhk->bshk", vis, p["wv"])
            if tm.cfg.qk_norm:
                k = rms_norm(k, p["k_norm"])
            out.append((k.numpy(), v.numpy()))
    return out


def _fill(jcache, tcache, kv):
    """Write the same vision K/V into both packages' cross caches."""
    for (k, v), c in zip(kv, tcache["seg0"]["cross"]):
        c.k.copy_(torch.from_numpy(k))
        c.v.copy_(torch.from_numpy(v))
    cross = jattn.KVCache(jnp.asarray(np.stack([k for k, _ in kv])),
                          jnp.asarray(np.stack([v for _, v in kv])))
    return {"seg0": {"self": jcache["seg0"]["self"], "cross": cross}}


@pytest.mark.parametrize("filled", [False, True], ids=["zero_cross", "filled_cross"])
@pytest.mark.parametrize("impl", ["naive", "blocked"])
def test_vlm_decode_logits_vs_repro(impl, filled):
    """Every decode step's logits over a prompt and its greedy continuation,
    with repro's zero cross caches or with both filled alike; the cross
    caches come back unchanged, as repro's."""
    jm, jp, tm = _model_pair(VLM, attention_impl=impl)
    B, prompt_len, gen = 2, 6, 5
    batch = _batch(tm.cfg, B=B, T=prompt_len, seed=1)
    jcache, tcache = jm.init_cache(B, prompt_len + gen), tm.init_cache(B, prompt_len + gen)
    n_super = tm.cfg.n_layers // tm.cfg.cross_attn_period
    assert len(tcache["seg0"]["cross"]) == len(tcache["seg0"]["self"]) == n_super
    assert all(len(c) == tm.cfg.cross_attn_period - 1 for c in tcache["seg0"]["self"])
    assert tcache["seg0"]["cross"][0].k.shape[1] == tm.cfg.vision_tokens
    if filled:
        jcache = _fill(jcache, tcache, _cross_kv(tm, batch["vision_embeds"]))
    cross_before = [c.k.clone() for c in tcache["seg0"]["cross"]]
    jdecode, tdecode = jax.jit(jm.decode_step), make_decode_step(tm)
    tok = batch["tokens"][:, :1]
    for pos in range(prompt_len + gen):
        jl, jcache = jdecode(jp, jcache, jnp.asarray(tok), pos)
        tl, tcache = tdecode({"cache": tcache, "tokens": torch.from_numpy(tok), "pos": pos})
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **MODEL_TOL)
        tok = (batch["tokens"][:, pos + 1:pos + 2] if pos + 1 < prompt_len
               else np.asarray(jl[:, -1].argmax(-1))[:, None].astype(np.int32))
    for before, c in zip(cross_before, tcache["seg0"]["cross"]):
        assert torch.equal(before, c.k)
    np.testing.assert_allclose(tcache["seg0"]["self"][1][0].k.numpy(),
                               np.asarray(jcache["seg0"]["self"].k)[1, 0], **MODULE_TOL)


def test_vlm_decode_with_filled_cross_caches_matches_forward():
    """tests/test_archs_smoke.py's teacher-forced check, which repro's vlm
    skips (its cross caches stay zero): with each cross cache filled with its
    block's vision K/V, the decode steps give the forward's logits."""
    cfg = configs.smoke_config(configs.get_arch(VLM)).replace(attention_impl="naive")
    tm = build_model(cfg, device="cpu")
    batch = _batch(cfg)
    full = make_prefill_step(tm)(_torch(batch))
    cache = tm.init_cache(2, 16)
    for (k, v), c in zip(_cross_kv(tm, batch["vision_embeds"]), cache["seg0"]["cross"]):
        c.k.copy_(torch.from_numpy(k))
        c.v.copy_(torch.from_numpy(v))
    step, outs = make_decode_step(tm), []
    for t in range(16):
        logits, cache = step({"cache": cache, "pos": t,
                              "tokens": torch.from_numpy(batch["tokens"][:, t:t + 1])})
        outs.append(logits[:, 0])
    torch.testing.assert_close(torch.stack(outs, 1), full, rtol=2e-3, atol=2e-3)


def test_vlm_carries_doubly_stacked_leaves():
    """repro's segments/seg0/self/<leaf> is (n_super, period - 1, ...) and
    segments/seg0/cross/<leaf> (n_super, ...): superblock s, self block i
    of the port gets [s, i], its cross block [s]; a wrong shape is named."""
    jm, jp, tm = _model_pair(VLM)
    cfg = tm.cfg
    n_super = cfg.n_layers // cfg.cross_attn_period
    seg = jp["segments"]["seg0"]
    assert seg["self"]["attn"]["wq"].shape[:2] == (n_super, cfg.cross_attn_period - 1)
    for s in range(n_super):
        for i in range(cfg.cross_attn_period - 1):
            np.testing.assert_array_equal(
                tm.segments["seg0"][s]["self"][i]["ffn"]["w_up"].detach().numpy(),
                seg["self"]["ffn"]["w_up"][s, i])
        np.testing.assert_array_equal(tm.segments["seg0"][s]["cross"]["attn"]["wk"].detach()
                                      .numpy(), seg["cross"]["attn"]["wk"][s])
    np.testing.assert_array_equal(tm.vision_proj["w"].detach().numpy(), jp["vision_proj"]["w"])
    bad = jax.tree.map(lambda a: a, jp)
    bad["segments"]["seg0"]["cross"]["attn"]["wv"] = seg["cross"]["attn"]["wv"][..., :-1]
    with pytest.raises(ValueError, match="/segments/seg0/0/cross/attn/wv"):
        load_jax_params(tm, bad)
    bad = jax.tree.map(lambda a: a, jp)
    bad["segments"]["seg0"]["self"]["norm1"]["scale"] = seg["self"]["norm1"]["scale"][..., :-1]
    with pytest.raises(ValueError, match="/segments/seg0/0/self/0/norm1/scale"):
        load_jax_params(tm, bad)


@pytest.mark.parametrize("arch", [VLM, AUDIO])
@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
def test_parameter_counts_are_repros(arch, smoke):
    """As many parameters as repro's init (the full configs by
    jax.eval_shape against a device="meta" build, no weights made; at
    smoke size load_jax_params has held every leaf's name and shape)."""
    jcfg, tcfg = jconfigs.get_arch(arch), configs.get_arch(arch)
    if smoke:
        jcfg, tcfg = jconfigs.smoke_config(jcfg), configs.smoke_config(tcfg)
    shapes = jax.eval_shape(jax_build_model(jcfg).init, jax.random.PRNGKey(0))
    n = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(shapes))
    tm = build_model(tcfg, device="meta", generator=torch.Generator())
    assert sum(p.numel() for p in tm.parameters()) == n
    if not smoke:
        # 20 superblocks of 4 self + 1 cross block; hubert whole
        assert n == {VLM: 87_729_709_056, AUDIO: 945_574_400}[arch]


def test_serve_refuses_the_audio_family():
    from repro_torch.launch import serve as tserve
    with pytest.raises(SystemExit, match="encoder-only"):
        tserve.serve(AUDIO, device="cpu")


# -- the audio family -------------------------------------------------------------------------


@pytest.mark.parametrize("impl", ["naive", "blocked", "pallas"])
def test_audio_forward_and_loss_vs_repro(impl):
    """hubert's per-frame logits and CE: repro's "pallas" in interpret mode,
    the port's kernel wrapper on its plain version; non-causal whatever
    the config says, as repro's build_audio_encoder forces."""
    jm, jp, tm = _model_pair(AUDIO, attention_impl=impl)
    assert tm.init_cache is None and tm.decode_step is None and tm.gqa.causal is False
    assert not hasattr(tm, "embed")
    batch = _batch(tm.cfg)
    ref = jax.jit(jm.forward)(jp, _jax(batch))
    out = make_prefill_step(tm)(_torch(batch))
    assert out.shape == ref.shape == (2, 16, tm.cfg.vocab)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **MODEL_TOL)
    jloss, _ = jax.jit(jm.loss_fn)(jp, _jax(batch))
    loss, metrics = tm.loss_fn(_torch(batch))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    assert set(metrics) == {"ce"}


def test_audio_is_non_causal_even_where_the_config_is_causal():
    _, jp, tm = _model_pair(AUDIO, causal=True, attention_impl="naive")
    jm = jax_build_model(jconfigs.smoke_config(jconfigs.get_arch(AUDIO)).replace(
        causal=True, attention_impl="naive"))
    batch = _batch(tm.cfg, seed=3)
    np.testing.assert_allclose(make_prefill_step(tm)(_torch(batch)).numpy(),
                               np.asarray(jax.jit(jm.forward)(jp, _jax(batch))), **MODEL_TOL)


# -- the trainer's batches --------------------------------------------------------------------


@pytest.mark.parametrize("arch", [VLM, AUDIO, "qwen3-1.7b"])
def test_batch_for_equals_repros(arch):
    """The trainer's family inputs from one token batch: audio frames from
    default_rng(tokens[0, 0]) and labels % vocab, the vlm's vision embeds
    from default_rng(0), float32, on the tokens' device."""
    cfg = configs.smoke_config(configs.get_arch(arch))
    jcfg = jconfigs.smoke_config(jconfigs.get_arch(arch))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    raw = lm_batch(3, 2, 16, 1000, seed=5)               # labels past the audio vocab
    ours = batch_for(cfg, None, _torch(raw))
    theirs = j_batch_for(jcfg, None, _jax(raw))
    assert ours.keys() == theirs.keys()
    for name, t in ours.items():
        assert t.dtype == {np.dtype(np.float32): torch.float32,
                           np.dtype(np.int32): torch.int32}[np.asarray(theirs[name]).dtype]
        np.testing.assert_array_equal(t.numpy(), np.asarray(theirs[name]), err_msg=name)
