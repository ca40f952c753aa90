"""Expert parallelism (``moe_impl="ep"``) on the card, at smoke size (no JAX:
this file runs on the card's machine, ``python -m pytest -q -m cuda
tests/test_torch_ep_card.py``).  The CPU half, against repro, is
``test_torch_ep.py``.

moonshot's ``smoke_config`` built by ``build_cell`` over a (2, 4) mesh of
positions as threads on the card, at capacity factor E / k (no slot can
drop on either path): its prefill (the flash kernel once a layer) within
1e-4 of max |logit| of the gather path's on the same weights, bit-equal from
run to run, and within 1e-3 of max |logit| of the same cell's CPU run; one
backward through EP with finite, nonzero gradients, x's bit-equal from run
to run."""

import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs  # noqa: E402
from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.launch import make_host_mesh  # noqa: E402
from repro_torch.launch.steps import build_cell  # noqa: E402
from repro_torch.models import ffn  # noqa: E402

ARCH = "moonshot-v1-16b-a3b"
EP_GAP = 1e-4       # of max |logit|, EP against the gather path
CARD_GAP = 1e-3     # of max |logit|, the card against the CPU


@pytest.fixture
def cuda():
    """The card, decided when the test runs (never at import or collection)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (EP on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False   # fp32 products, as on the CPU
    return torch.device("cuda")


def _cfg(**overrides):
    cfg = configs.smoke_config(configs.get_arch(ARCH))
    return cfg.replace(capacity_factor=cfg.n_experts / cfg.top_k, **overrides)


def _cells(device):
    mesh = make_host_mesh(data=2, model=4, device=device)
    shape = ShapeSpec("smoke", 64, 4, "prefill")
    ep = build_cell(_cfg(moe_impl="ep", attention_impl="pallas"), shape, mesh, device=device,
                    generator=torch.Generator(device).manual_seed(0))
    gather = build_cell(_cfg(attention_impl="pallas"), shape, mesh, device=device,
                        generator=torch.Generator(device).manual_seed(0))
    gather.model.load_state_dict(ep.model.state_dict())
    return ep, gather


@pytest.mark.cuda
def test_ep_prefill_against_the_gather_path_on_the_card(cuda):
    ep, gather = _cells(cuda)
    build.reset_launches()
    logits = ep.step(*ep.args)
    torch.cuda.synchronize()
    assert build.launch_counts()["flash_attention"] == ep.cfg.n_layers
    again = ep.step(*ep.args)
    assert torch.equal(logits, again), "EP is not bit-equal from run to run"
    want = gather.step(*ep.args)
    gap = float((logits - want).abs().max())
    assert gap <= EP_GAP * float(want.abs().max()), gap
    cpu_ep, _ = _cells("cpu")
    cpu_ep.model.load_state_dict({k: v.cpu() for k, v in ep.model.state_dict().items()})
    cpu_logits = cpu_ep.step(None, {k: v.cpu() for k, v in ep.args[1].items()})
    gap = float((logits.cpu() - cpu_logits).abs().max())
    assert gap <= CARD_GAP * float(cpu_logits.abs().max()), gap


@pytest.mark.cuda
def test_ep_backward_on_the_card(cuda):
    from repro_torch.launch import shardings as sh
    sh.set_mesh_axis_sizes(make_host_mesh(data=2, model=4, device=cuda))
    cfg = _cfg(moe_impl="ep")
    mcfg = ffn.MoEConfig(d_model=cfg.d_model, n_experts=cfg.n_experts, top_k=cfg.top_k,
                         d_ff_expert=cfg.d_ff_expert, n_shared=cfg.n_shared_experts,
                         capacity_factor=1.25, impl="ep")
    gen = torch.Generator(cuda).manual_seed(0)
    p = ffn.init_moe(mcfg, device=cuda, generator=gen)
    p.requires_grad_(True)
    x0 = torch.randn(4, 16, cfg.d_model, generator=gen, device=cuda)
    grads = []
    for _ in range(2):
        x = x0.clone().requires_grad_(True)
        y, aux = ffn.moe_ffn(p, x, mcfg)
        (y.square().sum() + aux).backward()
        grads.append(x.grad)
    assert torch.equal(grads[0], grads[1]), "x's gradient is not bit-equal from run to run"
    for name, t in p.named_parameters():
        assert torch.isfinite(t.grad).all() and bool(t.grad.abs().sum() > 0), name
