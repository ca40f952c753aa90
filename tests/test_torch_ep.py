"""The port's expert-parallel MoE (``moe_impl="ep"``) against repro's, on the
CPU.

repro's EP runs once, in a subprocess with 8 forced host devices on a mesh
(2, 4), as tests/test_spmd.py's EP test does (its forward limit, rtol/atol
2e-4, is the one here), and saves every reference to an ``.npz``; the port
runs the same mesh's positions as threads on the CPU with repro's weights
carried across.  ``_moe_ep``'s forward, aux (within 1e-6) and gradients
(x's and every weight's) at a capacity that drops slots and at one that
drops none, with a shared expert; the collective recorder's bytes against
the analytic count; each position's experts are views of the layer's
weights; two runs give the same bits.  Training: repro trains moonshot's
``smoke_config`` with ``moe_impl="ep"`` at ``train(data=2, model_axis=2)``
and checkpoints at step 4; its state carried into the port's checkpoint
format, the port's ``train`` on the same mesh resumes it, and its losses
are held to repro's uninterrupted run at test_torch_train.py's rtol 1e-4."""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from conftest import run_subprocess_devices  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro import optim as joptim  # noqa: E402
from repro.ft import restore_checkpoint as j_restore  # noqa: E402
from repro.models.build import build_model as j_build_model  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.ft import save_checkpoint  # noqa: E402
from repro_torch.launch import make_host_mesh, shardings as sh, train  # noqa: E402
from repro_torch.core.compat import record_collectives  # noqa: E402
from repro_torch.models import build_model, ffn, load_jax_opt_state, load_jax_params  # noqa: E402

EP_TOL = dict(rtol=2e-4, atol=2e-4)          # tests/test_spmd.py:174
AUX_TOL = 1e-6
LOSS_RTOL = 1e-4                             # tests/test_torch_train.py
MOE = "moonshot-v1-16b-a3b"
CASES = {"drop": dict(capacity_factor=1.25, n_shared=0), "full": dict(capacity_factor=8.0,
                                                                      n_shared=1)}
TRAIN = dict(smoke=True, batch=4, seq=32, seed=3, data=2, model_axis=2)
TRAIN_STEPS, RESUME_AT = 8, 4

# repro's side: every reference the tests below hold the port against
_REFERENCE = r'''
import jax, jax.numpy as jnp, numpy as np
from repro import configs as jc
from repro.launch.mesh import _mk
from repro.launch import shardings as sh
from repro.launch.train import train
from repro.models.ffn import MoEConfig, init_moe, moe_ffn
from repro.utils.tree import tree_flatten_with_paths

out = {}
mesh = _mk((2, 4), ("data", "model"))
sh.set_mesh_axis_sizes(mesh)
rng = np.random.default_rng(0)
x = rng.normal(size=(4, 16, 16)).astype(np.float32)
w = rng.normal(size=(4, 16, 16)).astype(np.float32)
out["x"], out["w"] = x, w
for name, kw in @CASES@.items():
    cfg = MoEConfig(d_model=16, n_experts=8, top_k=2, d_ff_expert=8, impl="ep", **kw)
    p = init_moe(jax.random.PRNGKey(1), cfg)
    def loss(p, x):
        y, aux = moe_ffn(p, x, cfg)
        return jnp.sum(y * w) + aux, (y, aux)
    with mesh:
        (_, (y, aux)), (gp, gx) = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True))(p, jnp.asarray(x))
    out[name + "_y"], out[name + "_aux"], out[name + "_gx"] = map(np.asarray, (y, aux, gx))
    for path, leaf in tree_flatten_with_paths(p):
        out[name + "_p_" + path] = np.asarray(leaf)
    for path, leaf in tree_flatten_with_paths(gp):
        out[name + "_g_" + path] = np.asarray(leaf)

jc.ARCHS["@MOE@"] = jc.ARCHS["@MOE@"].replace(moe_impl="ep")
kw = @TRAIN@
out["train_full"] = np.array(train("@MOE@", steps=@STEPS@, **kw))
train("@MOE@", steps=@RESUME@ + 1, ckpt_dir="@CKPT@", ckpt_every=@RESUME@,
      total_steps=@STEPS@, **kw)
np.savez("@OUT@", **out)
print("EP_REFERENCE_OK")
'''


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs files in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _restore_mesh_register():
    saved = (dict(sh._AXIS_SIZES), sh.CURRENT_MESH)
    yield
    sh._AXIS_SIZES, sh.CURRENT_MESH = saved


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """repro's EP and trainer on 8 forced host devices, run once."""
    root = tmp_path_factory.mktemp("ep")
    code = (_REFERENCE.replace("@OUT@", str(root / "reference.npz"))
            .replace("@CKPT@", str(root / "ckpt")).replace("@CASES@", repr(CASES))
            .replace("@TRAIN@", repr(TRAIN)).replace("@MOE@", MOE)
            .replace("@STEPS@", str(TRAIN_STEPS)).replace("@RESUME@", str(RESUME_AT)))
    out = run_subprocess_devices(code, n_devices=8)
    assert "EP_REFERENCE_OK" in out
    with np.load(root / "reference.npz") as z:
        data = {k: z[k] for k in z.files}
    data["ckpt"] = str(root / "ckpt")
    return data


def _cfg(case):
    return ffn.MoEConfig(d_model=16, n_experts=8, top_k=2, d_ff_expert=8, impl="ep",
                         **CASES[case])


def _nested(flat: dict, prefix: str) -> dict:
    """repro's dotted leaves under ``prefix`` as its nested dict."""
    tree: dict = {}
    for key, value in flat.items():
        if key.startswith(prefix):
            node = tree
            *parents, leaf = key[len(prefix):].split(".")
            for part in parents:
                node = node.setdefault(part, {})
            node[leaf] = value
    return tree


def _layer(ref, case):
    cfg = _cfg(case)
    return cfg, load_jax_params(ffn.init_moe(cfg, generator=torch.Generator()),
                                _nested(ref, f"{case}_p_"))


def _ep_mesh():
    sh.set_mesh_axis_sizes(make_host_mesh(data=2, model=4, device="cpu"))


@pytest.mark.parametrize("case", sorted(CASES))
def test_moe_ep_forward_aux_and_grads_vs_repro(ref, case):
    _ep_mesh()
    cfg, p = _layer(ref, case)
    p.requires_grad_(True)
    x = torch.from_numpy(ref["x"]).requires_grad_(True)
    y, aux = ffn.moe_ffn(p, x, cfg)
    np.testing.assert_allclose(y.detach().numpy(), ref[f"{case}_y"], **EP_TOL)
    assert abs(float(aux.detach()) - float(ref[f"{case}_aux"])) <= AUX_TOL
    (torch.sum(y * torch.from_numpy(ref["w"])) + aux).backward()
    np.testing.assert_allclose(x.grad.numpy(), ref[f"{case}_gx"], **EP_TOL)
    want = _nested(ref, f"{case}_g_")
    for name, t in p.named_parameters():
        node = want
        for part in name.split("."):
            node = node[part]
        np.testing.assert_allclose(t.grad.numpy(), node, err_msg=name, **EP_TOL)


def test_moe_ep_matches_the_dense_oracle(ref):
    """At a capacity that drops nothing, EP is the dense oracle."""
    _ep_mesh()
    cfg, p = _layer(ref, "full")
    x = torch.from_numpy(ref["x"])
    y, _ = ffn.moe_ffn(p, x, cfg)
    yd, _ = ffn.moe_ffn(p, x, cfg._replace(impl="dense"))
    torch.testing.assert_close(y, yd, **EP_TOL)


def test_moe_ep_collective_bytes_are_the_analytic_count(ref):
    """Per position a layer: two all-to-alls of E·C·D·4 bytes, one
    all-gather of the position's chunk·D·4 and one all-reduce of the fp32
    aux; wire bytes by the ring model."""
    _ep_mesh()
    cfg, p = _layer(ref, "drop")
    x = torch.from_numpy(ref["x"])
    with record_collectives() as rec:
        ffn.moe_ffn(p, x, cfg)
    M, D, E, k = 4, 16, 8, 2
    chunk = x.shape[0] * x.shape[1] // 2 // M
    C = max(1, int(math.ceil(k * chunk / E * cfg.capacity_factor)))
    a2a = E * C * D * 4
    for linear in range(8):
        st = rec.stats(linear)
        assert st.count_by_op == {"all-to-all": 2, "all-gather": 1, "all-reduce": 1}
        assert st.bytes_by_op == {"all-to-all": 2 * a2a, "all-gather": chunk * D * 4,
                                  "all-reduce": 4}
        assert st.wire_bytes_by_op == {"all-to-all": 2 * a2a * (M - 1) / M,
                                       "all-gather": chunk * D * 4 * (M - 1),
                                       "all-reduce": 2 * 4 * (M - 1) / M}


def test_moe_ep_positions_see_views_of_the_weights(ref, monkeypatch):
    _ep_mesh()
    cfg, p = _layer(ref, "full")
    seen = []
    local = ffn._moe_ep_local

    def spy(p_router, w_gate, w_up, w_down, x_m, cfg, ep_axis):
        seen.append([t.untyped_storage().data_ptr() for t in (p_router, w_gate, w_up, w_down)])
        return local(p_router, w_gate, w_up, w_down, x_m, cfg, ep_axis)

    monkeypatch.setattr(ffn, "_moe_ep_local", spy)
    ffn.moe_ffn(p, torch.from_numpy(ref["x"]), cfg)
    want = [p[n].untyped_storage().data_ptr() for n in ("router", "w_gate", "w_up", "w_down")]
    assert len(seen) == 8 and all(s == want for s in seen)


def test_moe_ep_runs_are_bit_equal_and_keep_grad_mode(ref):
    _ep_mesh()
    cfg, p = _layer(ref, "drop")
    x = torch.from_numpy(ref["x"])
    p.requires_grad_(True)
    with torch.no_grad():
        a, aux_a = ffn.moe_ffn(p, x, cfg)
        b, aux_b = ffn.moe_ffn(p, x, cfg)
    assert not a.requires_grad and torch.equal(a, b) and torch.equal(aux_a, aux_b)


def test_moe_ep_needs_a_mesh_and_divisible_experts(ref):
    cfg, p = _layer(ref, "full")
    sh.CURRENT_MESH = None
    with pytest.raises(RuntimeError, match="needs a mesh"):
        ffn.moe_ffn(p, torch.from_numpy(ref["x"]), cfg)
    sh.set_mesh_axis_sizes(make_host_mesh(data=1, model=3, device="cpu"))
    with pytest.raises(ValueError, match="do not split"):
        ffn.moe_ffn(p, torch.from_numpy(ref["x"]), cfg)


def test_train_on_the_ep_mesh_vs_repro(ref, tmp_path, monkeypatch):
    """repro's train(data=2, model_axis=2) with moe_impl="ep" checkpointed
    at step RESUME_AT; the port's train on the same mesh resumes it (its
    state carried into the port's checkpoint) and runs to TRAIN_STEPS:
    losses within rtol 1e-4 of repro's uninterrupted run."""
    jcfg = jconfigs.smoke_config(jconfigs.get_arch(MOE)).replace(moe_impl="ep")
    jm = j_build_model(jcfg, data_groups=TRAIN["data"])
    template = jm.init(jax.random.PRNGKey(TRAIN["seed"]))
    jopt = joptim.adamw(lr=joptim.warmup_cosine(3e-4, 1, TRAIN_STEPS))
    (jparams, jstate), _, step = j_restore(ref["ckpt"], (template, jopt.init(template)))
    assert step == RESUME_AT
    monkeypatch.setitem(configs.ARCHS, MOE, configs.get_arch(MOE).replace(moe_impl="ep"))
    tcfg = configs.smoke_config(configs.get_arch(MOE))
    tm = load_jax_params(build_model(tcfg, device="cpu"),
                         jax.tree.map(np.asarray, jparams))
    state = load_jax_opt_state(tm, jax.tree.map(np.asarray, jstate))
    save_checkpoint(str(tmp_path), RESUME_AT, (tm.param_tree(), state))
    losses = train(MOE, steps=TRAIN_STEPS, ckpt_dir=str(tmp_path), device="cpu", **TRAIN)
    assert len(losses) == TRAIN_STEPS - RESUME_AT - 1
    np.testing.assert_allclose(losses, ref["train_full"][RESUME_AT + 1:], rtol=LOSS_RTOL)
