"""The training path on the card (no JAX: this file runs on the card's
machine, ``python -m pytest -q -m cuda tests/test_torch_train_card.py``).
The CPU half, against repro, is ``test_torch_train.py``."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs  # noqa: E402
from repro_torch.data import lm_batch  # noqa: E402
from repro_torch.kernels.flash_attention.kernel import flash_attention_gqa  # noqa: E402
from repro_torch.kernels.ssd_scan.kernel import ssd_scan  # noqa: E402
from repro_torch.launch.steps import make_train_step  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.optim import adamw, warmup_cosine  # noqa: E402


@pytest.fixture
def cuda():
    """The card, decided when the test runs (never at import or collection)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the training path on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False   # fp32 products, as on the CPU
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen3-1.7b", "mamba2-2.7b", "zamba2-2.7b"])
def test_train_step_on_the_card_equals_the_cpus(cuda, arch):
    """One smoke_config step from the same weights and batch: loss, grad norm
    and parameters within 1e-4 of the CPU's."""
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
        out[dev] = (float(loss), float(metrics["grad_norm"]),
                    {k: v.detach().cpu() for k, v in params.items()})
    assert out["cuda"][0] == pytest.approx(out["cpu"][0], rel=1e-4)
    assert out["cuda"][1] == pytest.approx(out["cpu"][1], rel=1e-4)
    for name, p in out["cpu"][2].items():
        np.testing.assert_allclose(out["cuda"][2][name].numpy(), p.numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=name)


@pytest.mark.cuda
def test_kernels_refuse_backward_on_the_card(cuda):
    g = torch.Generator("cuda").manual_seed(0)
    q = torch.randn(1, 64, 2, 2, 64, device="cuda", generator=g, requires_grad=True)
    k = torch.randn(1, 64, 2, 64, device="cuda", generator=g, requires_grad=True)
    v = torch.randn(1, 64, 2, 64, device="cuda", generator=g, requires_grad=True)
    with pytest.raises(NotImplementedError, match="attention_impl='blocked'"):
        flash_attention_gqa(q, k, v).sum().backward()
    x = torch.randn(1, 128, 4, 64, device="cuda", generator=g, requires_grad=True)
    a = -torch.rand(1, 128, 4, device="cuda", generator=g)
    B = torch.randn(1, 128, 1, 128, device="cuda", generator=g)
    C = torch.randn(1, 128, 1, 128, device="cuda", generator=g)
    with pytest.raises(NotImplementedError, match="ssd_impl='chunked'"):
        ssd_scan(x, a, B, C, chunk=64).sum().backward()
    with torch.no_grad():          # forward only: the kernel, as before
        assert flash_attention_gqa(q, k, v).grad_fn is None
