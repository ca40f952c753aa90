"""The hybrid family (zamba2) on the card against the CPU (no JAX: this file
runs on the card's machine, ``python -m pytest -q -m cuda
tests/test_torch_hybrid_card.py``).  The CPU half, against repro, is
``test_torch_models.py`` and ``test_torch_train.py``.

At ``smoke_config`` with the same weights: the prefill on both kernels
(flash_attention once and ssd_scan ``hybrid_period`` times a superblock) and
every decode step's logits within 1e-3 of max |logit| of the CPU's plain
versions, with the launches counted.  Its train step on the card is a case
of ``test_torch_train_card.py``."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.launch.steps import make_decode_step, make_prefill_step  # noqa: E402
from repro_torch.models import build_model  # noqa: E402

ARCH = "zamba2-2.7b"
GAP = 1e-3          # of max |logit|: E at 3e-5 and F at 3e-4 through the stack


@pytest.fixture
def cuda():
    """The card, decided when the test runs (never at import or collection)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the hybrid family on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False   # fp32 products, as on the CPU
    return torch.device("cuda")


def _pair(**overrides):
    cfg = configs.smoke_config(configs.get_arch(ARCH)).replace(**overrides)
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
def test_hybrid_serving_on_the_kernels_equals_the_cpus(cuda):
    cfg, models = _pair(attention_impl="pallas", ssd_impl="pallas")
    n_super = cfg.n_layers // cfg.hybrid_period
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (2, 16))
                            .astype(np.int32))
    build.reset_launches()
    out = make_prefill_step(models["cuda"])({"tokens": toks.to(cuda)})
    counts = build.launch_counts()
    assert counts.get("flash_attention") == n_super, counts
    assert counts.get("ssd_scan") == n_super * cfg.hybrid_period, counts
    _close(out, make_prefill_step(models["cpu"])({"tokens": toks}), "prefill")
    caches = {dev: m.init_cache(2, 16) for dev, m in models.items()}
    steps = {dev: make_decode_step(m) for dev, m in models.items()}
    for pos in range(16):
        got = {}
        for dev in models:
            got[dev], caches[dev] = steps[dev]({"cache": caches[dev], "pos": pos,
                                               "tokens": toks[:, pos:pos + 1].to(dev)})
        _close(got["cuda"], got["cpu"], f"decode step {pos}")
