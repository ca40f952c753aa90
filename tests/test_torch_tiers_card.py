"""The tiered store on the card (no JAX: this file runs on the card's
machine, ``python -m pytest -q -m cuda tests/test_torch_tiers_card.py``).
The CPU half of the tier tests, against repro, is ``test_torch_tiers.py``."""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.shards import ShardedStore  # noqa: E402


@pytest.fixture
def cuda():
    """The card, decided when the test runs (never at import or collection)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (demotion copies off the card)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_tier_round_trip_on_the_card(cuda):
    """On the card: demotion copies a device tensor to the host, promotion
    back to the device as a new tensor; f32 and bf16 bit for bit, epochs
    kept, a caller's reference to the demoted tensor still valid."""
    gen = torch.Generator("cuda").manual_seed(0)
    vals = {"f32": torch.randn(1 << 16, device="cuda", generator=gen)}
    vals["bf16"] = vals["f32"].to(torch.bfloat16)
    for kind in ("host", "disk"):
        store = ShardedStore("cuda", cold_tier=kind, cold_budget=0)
        held = {}
        for name, v in vals.items():
            store.def_global(name, v)
            held[name] = store.get(name)
        store.def_global("pad", torch.zeros(4, device="cuda"))  # both now cold
        assert store.tier_stats()["cold_entries"] == len(vals)
        for name, v in vals.items():
            epoch = store.epoch(name)
            got = store.get(name)
            assert got.device.type == "cuda" and got.dtype == v.dtype
            assert torch.equal(got, v) and torch.equal(held[name], v)
            assert got.data_ptr() != held[name].data_ptr() and store.epoch(name) == epoch
        assert store.tier_stats()["promotions"] == len(vals)
        store.cold_tier.close()
