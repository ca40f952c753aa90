"""The dense family's last three configs on the card against the CPU (no
JAX: this file runs on the card's machine, ``python -m pytest -q -m cuda
tests/test_torch_dense_card.py``).  The CPU half, against repro, is
``test_torch_models.py`` and ``test_torch_dense.py``.

starcoder2-3b, qwen3-4b and qwen2-72b at ``smoke_config`` with their
published head layouts kept (24 query heads over 2 KV heads: G 12; 32 over
8: G 4; 64 over 8: G 8), the same weights on both devices: the prefill on
the flash kernel (once a layer, launches counted; QKV bias, LayerNorm and
the GELU FFN's biases on the card for starcoder2) and every decode step's
logits within 1e-3 of max |logit| of the CPU's plain versions."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.launch.steps import make_decode_step, make_prefill_step  # noqa: E402
from repro_torch.models import build_model  # noqa: E402

ARCHS = ["starcoder2-3b", "qwen3-4b", "qwen2-72b"]
GAP = 1e-3          # of max |logit|: E at 3e-5 through the stack


@pytest.fixture
def cuda():
    """The card, decided when the test runs (never at import or collection)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the dense family on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False   # fp32 products, as on the CPU
    return torch.device("cuda")


def _close(got, want, what):
    gap = float((got.cpu() - want).abs().max())
    assert gap <= GAP * float(want.abs().max()), f"{what}: max |dlogit| {gap}"


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCHS)
def test_dense_serving_on_the_kernel_equals_the_cpus(cuda, arch):
    whole = configs.get_arch(arch)
    cfg = configs.smoke_config(whole).replace(
        n_heads=whole.n_heads, n_kv_heads=whole.n_kv_heads, attention_impl="pallas")
    weights = build_model(cfg, device="cpu").state_dict()
    models = {}
    for dev in ("cpu", "cuda"):
        models[dev] = build_model(cfg, device=dev)
        models[dev].load_state_dict(weights)
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (2, 24))
                            .astype(np.int32))
    build.reset_launches()
    out = make_prefill_step(models["cuda"])({"tokens": toks.to(cuda)})
    assert build.launch_counts().get("flash_attention") == cfg.n_layers
    _close(out, make_prefill_step(models["cpu"])({"tokens": toks}), f"{arch} prefill")
    caches = {dev: m.init_cache(2, 24) for dev, m in models.items()}
    steps = {dev: make_decode_step(m) for dev, m in models.items()}
    for pos in range(24):
        got = {}
        for dev in models:
            got[dev], caches[dev] = steps[dev]({"cache": caches[dev], "pos": pos,
                                               "tokens": toks[:, pos:pos + 1].to(dev)})
        _close(got["cuda"], got["cpu"], f"{arch} decode step {pos}")
