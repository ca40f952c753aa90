"""The vlm (llama-3.2-vision, cross-attention) and audio (hubert) families on
the card against the CPU (no JAX: this file runs on the card's machine,
``python -m pytest -q -m cuda tests/test_torch_vlm_audio_card.py``).  The
CPU half, against repro, is ``test_torch_vlm_audio.py``,
``test_torch_models.py`` and ``test_torch_train.py``.

The flash kernel off its causal path, at the shapes these families give it
(held to its plain version at test_kernels.py's tolerances): the vlm's self
attention (causal, G 8), its cross-attention (non-causal, 2,048 queries
over 1,601 vision keys: the last KV tile holds one key), hubert's MHA at
head dim 80, non-causal.  Then at ``smoke_config`` with the same weights, a
prefill on the kernel (the launches counted) within 1e-3 of max |logit| of
the CPU's plain forward, and the vlm's decode steps over filled cross
caches likewise."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.flash_attention.kernel import flash_attention_gqa, gqa_plain  # noqa: E402
from repro_torch.launch.steps import make_decode_step, make_prefill_step  # noqa: E402
from repro_torch.models import build_model  # noqa: E402

GAP = 1e-3          # of max |logit|: E at 3e-5 through the stack
FLASH_TOL = {torch.float32: 3e-5, torch.bfloat16: 3e-2}
# (B, T, S, KH, G, d, causal): the vlm's self and cross attention, hubert's
SHAPES = {"vlm_self": (2, 2048, 2048, 8, 8, 128, True),
          "vlm_cross": (2, 2048, 1601, 8, 8, 128, False),
          "hubert": (2, 2048, 2048, 16, 1, 80, False)}


@pytest.fixture
def cuda():
    """The card, decided when the test runs (never at import or collection)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the vlm and audio families on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False   # fp32 products, as on the CPU
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_flash_attention_at_the_new_shapes(cuda, shape, dtype):
    b, t, s, kh, g, d, causal = SHAPES[shape]
    gen = torch.Generator(cuda).manual_seed(0)
    q = torch.randn(b, t, kh, g, d, device=cuda, generator=gen).to(dtype)
    k, v = (torch.randn(b, s, kh, d, device=cuda, generator=gen).to(dtype) for _ in range(2))
    out = flash_attention_gqa(q, k, v, causal=causal)
    ref = gqa_plain(q, k, v, causal=causal, q_offset=0)
    tol = FLASH_TOL[dtype]
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)


def _pair(arch, **overrides):
    cfg = configs.smoke_config(configs.get_arch(arch)).replace(**overrides)
    weights = build_model(cfg, device="cpu").state_dict()
    models = {}
    for dev in ("cpu", "cuda"):
        models[dev] = build_model(cfg, device=dev)
        models[dev].load_state_dict(weights)
    return cfg, models


def _close(got, want, what):
    gap = float((got.cpu() - want).abs().max())
    assert gap <= GAP * float(want.abs().max()), f"{what}: max |dlogit| {gap}"


def _batch(cfg, B=2, T=16):
    rng = np.random.default_rng(0)
    if cfg.family == "audio":
        return {"frames": torch.from_numpy(rng.normal(size=(B, T, cfg.frame_dim))
                                           .astype(np.float32))}
    return {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (B, T)).astype(np.int32)),
            "vision_embeds": torch.from_numpy(rng.normal(
                size=(B, cfg.vision_tokens, cfg.vision_dim)).astype(np.float32))}


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["llama-3.2-vision-90b", "hubert-xlarge"])
def test_prefill_on_the_kernel_equals_the_cpus(cuda, arch):
    """E once a layer (the vlm: each self block causal, each cross block
    over the vision tokens; hubert non-causal)."""
    cfg, models = _pair(arch, attention_impl="pallas")
    batch = _batch(cfg)
    build.reset_launches()
    out = make_prefill_step(models["cuda"])({k: v.to(cuda) for k, v in batch.items()})
    assert build.launch_counts().get("flash_attention") == cfg.n_layers
    _close(out, make_prefill_step(models["cpu"])(batch), "prefill")


@pytest.mark.cuda
def test_vlm_decode_over_filled_cross_caches_equals_the_cpus(cuda):
    cfg, models = _pair("llama-3.2-vision-90b")
    batch = _batch(cfg)
    caches = {}
    for dev, m in models.items():
        caches[dev] = m.init_cache(2, 16)
        with torch.no_grad():
            vis = m._vision_of({"vision_embeds": batch["vision_embeds"].to(dev)})
            for sblk, c in zip(m.segments["seg0"], caches[dev]["seg0"]["cross"]):
                c.k.copy_(torch.einsum("bsd,dhk->bshk", vis, sblk["cross"]["attn"]["wk"]))
                c.v.copy_(torch.einsum("bsd,dhk->bshk", vis, sblk["cross"]["attn"]["wv"]))
    steps = {dev: make_decode_step(m) for dev, m in models.items()}
    for pos in range(16):
        got = {}
        for dev in models:
            got[dev], caches[dev] = steps[dev]({
                "cache": caches[dev], "pos": pos,
                "tokens": batch["tokens"][:, pos:pos + 1].to(dev)})
        _close(got["cuda"], got["cpu"], f"decode step {pos}")
