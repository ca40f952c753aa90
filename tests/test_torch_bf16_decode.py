"""``repro``'s serving dtype policy on the port, on the CPU: bf16 parameters
and compute (``repro/launch/dryrun.py``'s ``cfg.replace(dtype="bfloat16")``)
through the same ``make_decode_step`` and ``init_cache``.  Each family that
decodes, at its ``smoke_config``, holds every decode step's logits to
``repro``'s in bf16 on ``repro``'s weights (bf16 from its init) within
BF16_DECODE_GAP of the step's max |logit|: the two packages round apart in
bf16 about as far as each lies from its own fp32 decode.  The caches take
``repro``'s dtypes; ``long_500k``'s decode cell (one token against a
524,288-deep cache) builds on meta for the ssm and hybrid archs with
``repro``'s cache shapes."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.launch.steps import input_specs as j_input_specs  # noqa: E402
from repro.models.build import build_model as jax_build_model  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.configs.base import SHAPES  # noqa: E402
from repro_torch.launch import make_host_mesh  # noqa: E402
from repro_torch.launch.steps import build_cell, make_decode_step  # noqa: E402
from repro_torch.models import build_model, load_jax_params  # noqa: E402

# max |dlogit| over max |logit| at each step, bf16 against repro's bf16: the
# largest seen here is zamba2's 3.75e-2 (mamba2 2.93e-2, deepseek 1.18e-2,
# qwen3 and moonshot 9.1e-3); chip_smoke.py's BF16_DECODE_GAP is the same
BF16_DECODE_GAP = 6e-2
DECODED = {"qwen3-1.7b": {}, "mamba2-2.7b": {}, "zamba2-2.7b": {},
           # decode routes one step at a time: a capacity at which no slot drops
           # in either package (tests/test_archs_smoke.py raises it to 8.0 too)
           "moonshot-v1-16b-a3b": {"capacity_factor": 8.0},
           "deepseek-v3-671b": {"capacity_factor": 8.0}}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs files in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _dtypes_by_field(tree) -> dict:
    """Each cache field's dtype (``k``, ``v``, ``conv``, ``ssm``, ``c_kv``,
    ...), from either package's tree of named tuples."""
    out = {}

    def visit(node):
        if hasattr(node, "_fields"):
            for f in node._fields:
                out.setdefault(f, set()).add(str(getattr(node, f).dtype).split(".")[-1])
        elif isinstance(node, dict):
            for v in node.values():
                visit(v)
        elif isinstance(node, (list, tuple)):
            for v in node:
                visit(v)

    visit(tree)
    return out


@pytest.mark.parametrize("arch", list(DECODED))
def test_bf16_decode_vs_repro(arch):
    jcfg = jconfigs.smoke_config(jconfigs.get_arch(arch)).replace(dtype="bfloat16",
                                                                  **DECODED[arch])
    tcfg = configs.smoke_config(configs.get_arch(arch)).replace(dtype="bfloat16",
                                                                **DECODED[arch])
    jm = jax_build_model(jcfg)
    jp = _np_tree(jm.init(jax.random.PRNGKey(0)))
    tm = load_jax_params(build_model(tcfg, device="cpu"), jp)
    B, prompt_len, gen = 2, 6, 5
    prompt = np.random.default_rng(1).integers(0, tcfg.vocab, size=(B, prompt_len)) \
        .astype(np.int32)
    jdecode, tdecode = jax.jit(jm.decode_step), make_decode_step(tm)
    jcache, tcache = jm.init_cache(B, prompt_len + gen), tm.init_cache(B, prompt_len + gen)
    assert _dtypes_by_field(tcache) == _dtypes_by_field(jcache)
    tok = prompt[:, :1]
    for pos in range(prompt_len + gen):
        jl, jcache = jdecode(jp, jcache, jnp.asarray(tok), pos)
        tl, tcache = tdecode({"cache": tcache, "tokens": torch.from_numpy(tok), "pos": pos})
        assert tl.dtype == torch.bfloat16
        want, got = np.asarray(jl.astype(jnp.float32)), tl.float().numpy()
        gap = np.abs(got - want).max() / np.abs(want).max()
        assert gap <= BF16_DECODE_GAP, (pos, gap)
        # teacher-forced on repro's tokens: a greedy flip of a near tie would
        # feed the two packages different inputs
        tok = (prompt[:, pos + 1:pos + 2] if pos + 1 < prompt_len
               else want[:, -1].argmax(-1)[:, None].astype(np.int32))
    assert _dtypes_by_field(tcache) == _dtypes_by_field(jcache)


def _stacked_shapes(tree) -> dict:
    """``(key, field) -> shape`` with the port's per-layer lists stacked as
    ``repro`` stacks its layers (a list of n equal leaves is one leaf with a
    leading n)."""
    out = {}

    def visit(node, key, lead):
        if hasattr(node, "_fields"):
            for f in node._fields:
                out[(key, f)] = lead + tuple(getattr(node, f).shape)
        elif isinstance(node, dict):
            for k, v in node.items():
                visit(v, k, lead)
        else:
            assert all(_stacked_of(x) == _stacked_of(node[0]) for x in node)
            visit(node[0], key, lead + (len(node),))

    visit(tree, None, ())
    return out


def _stacked_of(node):
    return tuple(getattr(node, f).shape for f in node._fields) if hasattr(node, "_fields") \
        else (len(node), _stacked_of(node[0])) if isinstance(node, list) else None


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "zamba2-2.7b"])
def test_long_500k_cell_on_meta(arch):
    """The cell ``chip_smoke.py`` runs on the card, on meta: nothing
    allocated, the cache of one 524,288-deep sequence in repro's shapes and
    dtypes (zamba2: 9 KV caches of 524,288 x 32 x 80 in bf16, 48.3 GB)."""
    shape = SHAPES["long_500k"]
    tcfg = configs.get_arch(arch).replace(dtype="bfloat16")
    cell = build_cell(tcfg, shape, make_host_mesh(1, 1, device="cpu"), device="meta")
    cache = cell.args[1]["cache"]
    jcfg = jconfigs.get_arch(arch).replace(dtype="bfloat16")
    jspecs = j_input_specs(jcfg.replace(batch_axes=("data",)), jconfigs.SHAPES["long_500k"],
                           jax_build_model(jcfg))
    assert _stacked_shapes(cache) == _stacked_shapes(jspecs["cache"])
    assert _dtypes_by_field(cache) == _dtypes_by_field(jspecs["cache"])
    assert all(t.device.type == "meta" for t in cell.model.parameters())
    kv_bytes = sum(t.numel() * t.element_size() for c in cache.get("attn", []) for t in c)
    if arch == "zamba2-2.7b":
        assert kv_bytes == 9 * 2 * 524_288 * 32 * 80 * 2
    assert tuple(cell.args[1]["tokens"].shape) == (1, 1)
