"""The same weights from a seed on the card as on the CPU (no JAX: this file
runs on the card's machine, ``python -m pytest -q -m cuda
tests/test_torch_seed_card.py``).  The stream's bits are equal on both
devices; the draws after ``erfinv`` within ``seed_model.F32_ULPS`` float32
steps (``BF16_ULPS`` in bf16); ``train()`` from a seed gives the CPU's
losses within 1e-4.  The CPU half is ``test_torch_seed.py``."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from seed_model import BF16_ULPS, F32_ULPS, ulps, ulps_bf16  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.launch import make_host_mesh, train  # noqa: E402
from repro_torch.launch.steps import build_cell  # noqa: E402
from repro_torch.models import build_model, common  # noqa: E402
from repro_torch.utils.tree import tree_leaves  # noqa: E402

ARCHS = ["qwen3-1.7b", "starcoder2-3b", "mamba2-2.7b", "zamba2-2.7b", "moonshot-v1-16b-a3b",
         "deepseek-v3-671b", "llama-3.2-vision-90b", "hubert-xlarge"]
TRAIN_RTOL = 1e-4                  # chip_smoke.py phase 8's card-against-CPU limit


@pytest.fixture
def cuda():
    """The card, decided when the test runs (never at import or collection)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the weights drawn on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False   # fp32 products, as on the CPU
    return torch.device("cuda")


def within(card: torch.Tensor, cpu: torch.Tensor) -> int:
    """The two tensors' distance in steps of their dtype, asserted within the
    bound: equal bits for integers, F32_ULPS / BF16_ULPS for floats."""
    card, cpu = card.detach().cpu(), cpu.detach()
    assert card.dtype == cpu.dtype and card.shape == cpu.shape
    if not cpu.dtype.is_floating_point:
        assert torch.equal(card, cpu)
        return 0
    if cpu.dtype == torch.bfloat16:
        d = ulps_bf16(card.view(torch.int16).numpy(), cpu.view(torch.int16).numpy())
        assert d <= BF16_ULPS
        return d
    d = ulps(card.numpy(), cpu.numpy())
    assert d <= F32_ULPS
    return d


@pytest.mark.cuda
def test_stream_bits_equal_on_the_card(cuda):
    for key, start, n in ((0, 0, 1000), (common.leaf_key(5, 3), 2**32 + 7, (1 << 24) + 513)):
        assert torch.equal(common.hash_bits(key, start, n, cuda).cpu(),
                           common.hash_bits(key, start, n, "cpu"))
    key = common.leaf_key(1, 1)
    for dtype in (torch.int32, torch.int64):
        assert torch.equal(common.draw(key, (3000, 999), kind="integers", high=151_936,
                                       dtype=dtype, device=cuda).cpu(),
                           common.draw(key, (3000, 999), kind="integers", high=151_936,
                                       dtype=dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["normal", "truncated_normal"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_draws_on_the_card_within_the_bound(cuda, kind, dtype):
    """3 M values over one chunk boundary, printed: the largest distance."""
    key = common.leaf_key(9, 4)
    shape = (3, (1 << 20) + 5)
    d = within(common.draw(key, shape, kind=kind, scale=0.03125, dtype=dtype, device=cuda),
               common.draw(key, shape, kind=kind, scale=0.03125, dtype=dtype))
    print(f"{kind} {dtype}: card against CPU, at most {d} steps apart")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_build_model_on_the_card_equals_the_cpus(cuda, arch, dtype):
    """Every leaf, a CUDA generator read only for its seed."""
    cfg = configs.smoke_config(configs.get_arch(arch)).replace(dtype=dtype)
    gen = torch.Generator("cuda").manual_seed(3)
    torch.randn(10, device=cuda, generator=gen)          # the state moves; the seed not
    card = build_model(cfg, device=cuda, generator=gen).state_dict()
    cpu = build_model(cfg, device="cpu", generator=3).state_dict()
    assert card.keys() == cpu.keys()
    worst = max(within(card[k], cpu[k]) for k in cpu)
    print(f"{arch} {dtype}: {len(cpu)} leaves, at most {worst} steps apart")


@pytest.mark.cuda
@pytest.mark.parametrize("arch,kind", [("qwen3-1.7b", "train"), ("zamba2-2.7b", "decode"),
                                       ("llama-3.2-vision-90b", "prefill"),
                                       ("hubert-xlarge", "train")])
def test_build_cell_batch_on_the_card_equals_the_cpus(cuda, arch, kind):
    cfg = configs.smoke_config(configs.get_arch(arch))
    shape = ShapeSpec(f"small_{kind}", 32, 2, kind)
    cells = [build_cell(cfg, shape, make_host_mesh(1, 1, device=dev), device=dev,
                        generator=7) for dev in (cuda, "cpu")]
    for card, cpu in zip(*(tree_leaves(c.args[:-1] if kind == "train" else c.args)
                           for c in cells)):
        within(card, cpu)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen3-1.7b", "mamba2-2.7b", "zamba2-2.7b",
                                  "moonshot-v1-16b-a3b", "deepseek-v3-671b",
                                  "llama-3.2-vision-90b", "hubert-xlarge"])
def test_train_on_the_card_equals_the_cpus(cuda, arch):
    """ROADMAP Queue 3 fault 4: train() from a seed, two steps, on each device:
    the same initial weights, so the losses agree within 1e-4 relative."""
    kw = dict(smoke=True, steps=2, batch=2, seq=32, seed=0, log_every=1)
    card, cpu = train(arch, device="cuda", **kw), train(arch, device="cpu", **kw)
    np.testing.assert_allclose(card, cpu, rtol=TRAIN_RTOL)
    print(f"{arch}: losses card {card} CPU {cpu}")
