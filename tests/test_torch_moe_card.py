"""The moe family (moonshot with GQA, deepseek with MLA and MTP) on the card
against the CPU (no JAX: this file runs on the card's machine, ``python -m
pytest -q -m cuda tests/test_torch_moe_card.py``).  The CPU half, against
repro, is ``test_torch_moe.py``, ``test_torch_models.py`` and
``test_torch_train.py``.

At ``smoke_config`` with the same weights: the prefill on the flash kernel
(once a layer; MLA at dk != dv) and every decode step's logits within 1e-3
of max |logit| of the CPU's plain versions, with the launches counted; one
train step's loss, aux, MTP loss, grad norm and parameters within 1e-4 of
the CPU's; the MoE gather path bit-equal from run to run on the card,
forward and backward (its gathers are permutations: no atomics), with no
host sync in a layer (``torch.cuda.set_sync_debug_mode``); the flash
kernel at MLA's
head dims (dk 192, dv 128) held to its plain version."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs  # noqa: E402
from repro_torch.data import lm_batch  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.flash_attention.kernel import flash_attention_gqa, gqa_plain  # noqa: E402
from repro_torch.launch.steps import make_decode_step, make_prefill_step, make_train_step  # noqa: E402
from repro_torch.models import build_model, ffn  # noqa: E402
from repro_torch.optim import adamw, warmup_cosine  # noqa: E402

ARCHS = ["moonshot-v1-16b-a3b", "deepseek-v3-671b"]
GAP = 1e-3          # of max |logit|: E at 3e-5 through the stack
FLASH_TOL = {torch.float32: 3e-5, torch.bfloat16: 3e-2}


@pytest.fixture
def cuda():
    """The card, decided when the test runs (never at import or collection)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the moe family on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False   # fp32 products, as on the CPU
    return torch.device("cuda")


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


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_serving_on_the_kernel_equals_the_cpus(cuda, arch):
    cfg, models = _pair(arch, attention_impl="pallas", capacity_factor=8.0)
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (2, 16))
                            .astype(np.int32))
    build.reset_launches()
    out = make_prefill_step(models["cuda"])({"tokens": toks.to(cuda)})
    counts = build.launch_counts()
    assert counts.get("flash_attention") == cfg.n_layers, counts
    _close(out, make_prefill_step(models["cpu"])({"tokens": toks}), "prefill")
    caches = {dev: m.init_cache(2, 16) for dev, m in models.items()}
    steps = {dev: make_decode_step(m) for dev, m in models.items()}
    for pos in range(16):
        got = {}
        for dev in models:
            got[dev], caches[dev] = steps[dev]({"cache": caches[dev], "pos": pos,
                                               "tokens": toks[:, pos:pos + 1].to(dev)})
        _close(got["cuda"], got["cpu"], f"decode step {pos}")


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_train_step_on_the_card_equals_the_cpus(cuda, arch):
    """One smoke_config step from the same weights and batch: loss, its
    metrics (ce, aux; deepseek's mtp), grad norm and parameters within 1e-4
    of the CPU's."""
    cfg = configs.smoke_config(configs.get_arch(arch))
    batch = lm_batch(0, 2, 16, cfg.vocab, seed=1)
    weights = build_model(cfg, device="cpu").state_dict()
    out = {}
    for dev in ("cpu", "cuda"):
        model = build_model(cfg, device=dev)
        model.load_state_dict(weights)
        opt = adamw(lr=warmup_cosine(1e-3, 1, 10), eps=1e-3)
        params = model.param_tree()
        params, _, loss, metrics = make_train_step(model, opt)(
            params, opt.init(params), {k: torch.from_numpy(v).to(dev) for k, v in batch.items()},
            0)
        out[dev] = (float(loss), {k: float(v) for k, v in metrics.items()},
                    {k: v.detach().cpu() for k, v in params.items()})
    assert out["cuda"][0] == pytest.approx(out["cpu"][0], rel=1e-4)
    assert out["cuda"][1].keys() == out["cpu"][1].keys() >= {"ce", "aux", "grad_norm"}
    for name, v in out["cpu"][1].items():
        assert out["cuda"][1][name] == pytest.approx(v, rel=1e-4), name
    for name, p in out["cpu"][2].items():
        np.testing.assert_allclose(out["cuda"][2][name].numpy(), p.numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_gather_is_deterministic_on_the_card(cuda, dtype):
    """Two runs of the gather path on the card give the same bits, forward
    and backward, and agree with the CPU's; slots are dropped here."""
    cfg = ffn.MoEConfig(d_model=64, n_experts=16, top_k=4, d_ff_expert=32, n_shared=1,
                        capacity_factor=0.75, data_groups=2)
    cpu = ffn.init_moe(cfg, dtype=dtype, generator=torch.Generator().manual_seed(0))
    x = torch.randn(4, 96, 64, generator=torch.Generator().manual_seed(1)).to(dtype)
    loads, C = ffn.expert_loads(cpu, x, cfg)
    assert int(loads.max()) > C                      # some slots are dropped
    card = ffn.init_moe(cfg, dtype=dtype, device=cuda)
    card.load_state_dict(cpu.state_dict())
    card.requires_grad_(True)
    runs = []
    for _ in range(2):
        xc = x.to(cuda, copy=True).requires_grad_(True)
        y, aux = card(xc, cfg)
        (y.float().square().sum() + aux).backward()
        runs.append([y.detach().clone(), aux.detach().clone(), xc.grad.clone()]
                    + [p.grad.clone() for p in card.parameters()])
        card.zero_grad()
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    with torch.no_grad():
        y_cpu, aux_cpu = cpu(x, cfg)
    tol = 1e-4 if dtype == torch.float32 else 3e-2
    torch.testing.assert_close(runs[0][0].cpu().float(), y_cpu.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(runs[0][1].cpu(), aux_cpu, rtol=1e-5, atol=1e-7)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_steps_do_not_sync_the_host(cuda, arch):
    """A forward and a decode step on the card read nothing back to the
    host (as far as PyTorch's sync debug mode sees: .item(), nonzero, a
    copy to the host, a synchronize)."""
    cfg = configs.smoke_config(configs.get_arch(arch))
    model = build_model(cfg, device=cuda)
    toks = torch.zeros(2, 8, dtype=torch.int32, device=cuda)
    cache = model.init_cache(2, 8)
    with torch.no_grad():
        model.forward({"tokens": toks})                     # warm-up
        model.decode_step(cache, toks[:, :1], 0)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            model.forward({"tokens": toks})
            model.decode_step(cache, toks[:, 1:2], 1)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_at_mla_head_dims(cuda, dtype):
    """E at deepseek's MLA shape cut in batch, length and heads: q (1, 300, 8,
    1, 192), k (1, 300, 8, 192), v (1, 300, 8, 128), causal."""
    g = torch.Generator("cuda").manual_seed(0)
    q = torch.randn(1, 300, 8, 1, 192, device=cuda, generator=g).to(dtype)
    k = torch.randn(1, 300, 8, 192, device=cuda, generator=g).to(dtype)
    v = torch.randn(1, 300, 8, 128, device=cuda, generator=g).to(dtype)
    out = flash_attention_gqa(q, k, v, causal=True)
    assert out.shape == (1, 300, 8, 1, 128)
    tol = FLASH_TOL[dtype]
    torch.testing.assert_close(out.float(), gqa_plain(q, k, v, causal=True, q_offset=0).float(),
                               rtol=tol, atol=tol)
