"""The dense family's full configs on the port against repro's.

starcoder2-3b (LayerNorm, GELU FFN with biases, QKV bias; 24 query heads
over 2 KV heads), qwen3-4b (qk-norm; 32 over 8) and qwen2-72b (QKV bias; 64
over 8, FFN 29,568, vocab 152,064) at their published widths: every
parameter's name and shape equal to repro's init by ``jax.eval_shape``
against a ``device="meta"`` build (no weights are made), with the totals
that ``chip_smoke.py`` prints, at qwen2-72b's depth cuts too (it holds 291
GB in fp32; ``chip_smoke.py`` runs 15 layers in fp32 and 36 in bf16).
Forward, decode and serve at smoke size against repro are cases of
``test_torch_models.py``; the card against the CPU is
``test_torch_dense_card.py``."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro import configs as jconfigs  # noqa: E402
from repro.models.build import build_model as jax_build_model  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models import build_model  # noqa: E402

# qwen2-72b: 2,491,424,768 parameters outside the layers, 877,684,736 a layer
QWEN2_OUTSIDE, QWEN2_LAYER = 2_491_424_768, 877_684_736


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs files in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch,n_layers,want", [
    ("starcoder2-3b", None, 3_181_274_112),
    ("qwen3-4b", None, 4_411_424_256),
    ("qwen2-72b", None, 72_706_203_648),
    ("qwen2-72b", 15, QWEN2_OUTSIDE + 15 * QWEN2_LAYER),
    ("qwen2-72b", 36, QWEN2_OUTSIDE + 36 * QWEN2_LAYER),
], ids=["starcoder2-3b", "qwen3-4b", "qwen2-72b", "qwen2-72b-15", "qwen2-72b-36"])
def test_dense_parameters_are_repros(arch, n_layers, want):
    jcfg, tcfg = jconfigs.get_arch(arch), configs.get_arch(arch)
    if n_layers is not None:
        jcfg, tcfg = jcfg.replace(n_layers=n_layers), tcfg.replace(n_layers=n_layers)
    shapes = jax.eval_shape(jax_build_model(jcfg).init, jax.random.PRNGKey(0))
    leaves = jax.tree_util.tree_flatten_with_path(shapes)[0]
    jshapes = {"/".join(k.key for k in path): tuple(a.shape) for path, a in leaves}
    tm = build_model(tcfg, device="meta", generator=0)
    ours = {}                             # repro's leaf -> (port tensors, layer axes)
    for name, p in tm.named_parameters():
        parts = name.split(".")
        layers = sum(part.isdigit() for part in parts)
        key = "/".join(part for part in parts if not part.isdigit())
        assert jshapes[key][layers:] == tuple(p.shape), name
        assert p.dtype == torch.float32, name
        ours[key] = (ours.get(key, (0, layers))[0] + 1, layers)
    assert ours.keys() == jshapes.keys()
    for key, (n, layers) in ours.items():  # one port tensor per stacked layer
        assert n == int(np.prod(jshapes[key][:layers])), key
    total = sum(p.numel() for p in tm.parameters())
    assert total == sum(int(np.prod(a.shape)) for _, a in leaves) == want
    # the features each config brings to the card
    names = {name.split(".")[-1] for name, _ in tm.named_parameters()}
    if tcfg.qkv_bias:
        assert {"bq", "bk", "bv"} <= names, names
    if tcfg.qk_norm:
        assert {"q_norm", "k_norm"} <= names, names
