"""The port's meshes, sharding rules, cells, roofline and dry run against
repro's, on the CPU.

``param_specs`` (fsdp on and off), ``cache_specs`` and ``batch_shard_specs``
equal repro's leaf for leaf for every arch's ``smoke_config`` on meshes
(4, 2) and (2, 2, 2): a port leaf carries a layer index in its name where
repro's carries a leading stack dim, so its spec is repro's with those dims
dropped (they are ``None``).  repro's rules read only a mesh's axis names
and sizes, so its side runs on a stand-in of that shape in this process.
``model_flops`` / ``matmul_param_count`` equal repro's for every arch ×
``SHAPES`` entry.  The collectives (``all_to_all`` both ways, ``pmean``)
against numpy; the collective recorder's rules against repro's HLO parser
on tests/test_hlo_parser.py's module.  A meta ``build_cell`` allocates
nothing and counts the flops and bytes of a CPU run of the same cell
(tests/test_dryrun_mini.py's cells), and the dry run writes repro's
records on the H100's constants."""

import math
import os
import subprocess
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro import configs as jconfigs  # noqa: E402
from repro import launch as jlaunch  # noqa: E402
from repro import utils as jutils  # noqa: E402
from repro.launch import roofline as jroofline  # noqa: E402
from repro.launch import shardings as jsh  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models.build import build_model as j_build_model  # noqa: E402
from repro.utils.hlo import collective_bytes_from_hlo as j_collective_bytes  # noqa: E402
from repro.utils.tree import tree_flatten_with_paths as j_flatten  # noqa: E402
from repro_torch import configs, launch, utils  # noqa: E402
from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.core.compat import (  # noqa: E402
    P, all_gather, all_to_all, axis_index, in_positions, pmean, psum, psum_scatter,
    record_collectives, run_positions, shard_map)
from repro_torch.launch import dryrun, mesh as tmesh, roofline, shardings as sh  # noqa: E402
from repro_torch.launch.steps import (  # noqa: E402
    abstract_params, batch_shard_specs, build_cell, input_specs)
from repro_torch.models import build_model  # noqa: E402
from repro_torch.utils.hlo import collective_bytes_from_hlo  # noqa: E402
from repro_torch.utils.tree import tree_flatten_with_paths, tree_leaves  # noqa: E402

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
ARCHS = sorted(configs.ARCHS)
MESHES = {"4x2": ((4, 2), ("data", "model")), "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs files in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _restore_mesh_registers():
    """Each package's rules read the registered axis sizes: put both back."""
    saved = (dict(jsh._AXIS_SIZES), jsh.CURRENT_MESH, dict(sh._AXIS_SIZES), sh.CURRENT_MESH)
    yield
    jsh._AXIS_SIZES, jsh.CURRENT_MESH, sh._AXIS_SIZES, sh.CURRENT_MESH = saved


def _meshes(name):
    shape, names = MESHES[name]
    stand_in = types.SimpleNamespace(shape=dict(zip(names, shape)), axis_names=names)
    return stand_in, tmesh._mk(shape, names, device="meta")


def _repro_name(port_name: str) -> str:
    """repro's path of a port leaf: the layer indices dropped."""
    return ".".join(p for p in port_name.split(".") if not p.isdigit())


def _hold(theirs: dict, ours: dict, what: str):
    """Every port leaf's spec is repro's (same path) with repro's leading
    stack dims dropped; repro's leaves all have a port counterpart."""
    assert ours, what
    seen = set()
    for name, (shape, spec) in ours.items():
        path = _repro_name(name)
        jshape, jspec = theirs[path]
        lead = len(jshape) - len(shape)
        assert tuple(jshape[lead:]) == tuple(shape), (what, name, jshape, shape)
        assert all(a is None for a in tuple(jspec)[:lead]), (what, name, jspec)
        assert tuple(jspec)[lead:] == tuple(spec), (what, name, jspec, spec)
        seen.add(path)
    assert seen == set(theirs), (what, set(theirs) - seen)


def _flat(flatten, tree, specs, leaves_of):
    return {path: (tuple(x.shape), s)
            for (path, x), s in zip(flatten(tree), leaves_of(specs))}


def _jspec_leaves(specs):
    return jax.tree.leaves(specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))


def _pair(arch, **overrides):
    jcfg = jconfigs.smoke_config(jconfigs.get_arch(arch)).replace(**overrides)
    tcfg = configs.smoke_config(configs.get_arch(arch)).replace(**overrides)
    return jcfg, tcfg


# -- sharding rules ------------------------------------------------------------------------


@pytest.mark.parametrize("fsdp", [False, True], ids=["tp", "fsdp"])
@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_repros(arch, mesh_name, fsdp):
    jmesh, tmesh_ = _meshes(mesh_name)
    jsh.set_mesh_axis_sizes(jmesh)
    sh.set_mesh_axis_sizes(tmesh_)
    jcfg, tcfg = _pair(arch)
    jm = j_build_model(jcfg)
    jparams = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0)))
    theirs = _flat(j_flatten, jparams, jsh.param_specs(jparams, fsdp=fsdp), _jspec_leaves)
    params = build_model(tcfg, device="meta").param_tree()
    ours = _flat(tree_flatten_with_paths, params, sh.param_specs(params, fsdp=fsdp),
                 sh._spec_leaves)
    _hold(theirs, ours, f"{arch} params")


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_and_batch_specs_equal_repros(arch, mesh_name):
    jmesh, tmesh_ = _meshes(mesh_name)
    jsh.set_mesh_axis_sizes(jmesh)
    sh.set_mesh_axis_sizes(tmesh_)
    jcfg, tcfg = _pair(arch)
    jm = j_build_model(jcfg)
    tm = build_model(tcfg, device="meta")
    for kind in ("train", "prefill", "decode"):
        shape = ShapeSpec("mini", 64, 8, kind)
        jshape = jconfigs.ShapeSpec("mini", 64, 8, kind)
        if kind == "decode" and not tcfg.has_decode:
            continue
        jbatch = jsteps.input_specs(jcfg, jshape, jm)
        jspecs = jsteps.batch_shard_specs(jcfg, jshape, jmesh, jm, jbatch)
        tbatch = input_specs(tcfg, shape, tm)
        tspecs = batch_shard_specs(tcfg, shape, tmesh_, tm, tbatch)
        assert all(t.device.type == "meta" for t in tree_leaves(tbatch))
        _hold(_flat(j_flatten, jbatch, jspecs, _jspec_leaves),
              _flat(tree_flatten_with_paths, tbatch, tspecs, sh._spec_leaves),
              f"{arch} {kind} batch")
        if kind == "decode":
            jcache, tcache = jbatch["cache"], tbatch["cache"]
            _hold(_flat(j_flatten, jcache, jsh.cache_specs(jcache, jmesh), _jspec_leaves),
                  _flat(tree_flatten_with_paths, tcache, sh.cache_specs(tcache, tmesh_),
                        sh._spec_leaves), f"{arch} cache")


def test_sanitize_and_batch_spec():
    _, m = _meshes("2x2x2")
    assert sh.batch_spec(m) == P(("pod", "data"), None)
    assert sh.sanitize_spec(P(("pod", "data"), None, "model"), (1, 3, 4), m) == P(None, None,
                                                                                   "model")
    specs = sh.sanitize_tree({"a": P("data"), "b": P("model", None)},
                             {"a": torch.empty(3, device="meta"),
                              "b": torch.empty(4, 2, device="meta")}, m)
    assert specs == {"a": P(None), "b": P("model", None)}


def test_to_shardings_gives_views():
    _, m = _meshes("4x2")
    shard = sh.to_shardings({"w": P("data", "model")}, m)["w"]
    x = torch.arange(8 * 6, dtype=torch.float32).reshape(8, 6)
    for linear in range(m.size):
        block = shard.shard(x, linear)
        c = m.coords(linear)
        assert block.untyped_storage().data_ptr() == x.untyped_storage().data_ptr()
        assert torch.equal(block, x[2 * c["data"]:2 * c["data"] + 2, 3 * c["model"]:3 * c["model"] + 3])


# -- meshes and exports --------------------------------------------------------------------


def test_exports_and_h100_constants():
    assert set(jlaunch.__all__) <= set(launch.__all__) and "train" in launch.__all__
    assert set(jutils.__all__) <= set(utils.__all__)
    assert launch.PEAK_FLOPS_BF16 == 989.4e12 and launch.HBM_BW == 3.35e12
    assert launch.ICI_LINK_BW == 450e9 and launch.HBM_BYTES == 80 * 10**9
    m = launch.make_production_mesh()
    assert m.shape == {"data": 16, "model": 16} and launch.dp_degree(m) == 16
    mm = launch.make_production_mesh(multi_pod=True)
    assert mm.size == 512 and launch.data_axes(mm) == ("pod", "data")
    assert launch.dp_degree(mm) == 32
    h = launch.make_host_mesh(2, 4)
    assert h.shape == {"data": 2, "model": 4} and launch.data_axes(h) == ("data",)
    assert launch.make_host_mesh(2, 2, pod=2).axis_names == ("pod", "data", "model")


# -- roofline ------------------------------------------------------------------------------


@pytest.mark.parametrize("shape_name", sorted(configs.SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_equal_repros(arch, shape_name):
    tcfg, jcfg = configs.get_arch(arch), jconfigs.get_arch(arch)
    assert roofline.matmul_param_count(tcfg) == jroofline.matmul_param_count(jcfg)
    assert roofline.model_flops(tcfg, configs.SHAPES[shape_name]) == \
        jroofline.model_flops(jcfg, jconfigs.SHAPES[shape_name])
    total, routed = roofline.matmul_param_count(tcfg)
    assert roofline.active_param_count(tcfg, total, routed) == \
        jroofline.active_param_count(jcfg, total, routed)


def test_analyse_and_records(tmp_path):
    """analyse's terms on the H100 constants; a record round-trips."""
    cfg, shape = configs.get_arch("qwen3-1.7b"), configs.SHAPES["train_4k"]
    metrics = {"flops": 2e12, "bytes": 6.7e9, "coll_bytes": 9e9, "coll_by_op": {"all-reduce": 9e9},
               "arg_bytes": 10.0, "out_bytes": 4.0, "temp_bytes": 3.0, "alias_bytes": 2.0}
    rec = roofline.analyse(cfg, shape, "single", 256, metrics, 1.5, 123)
    assert rec.compute_s == 2e12 / 989.4e12 and rec.memory_s == 6.7e9 / 3.35e12
    assert rec.collective_s == 9e9 / 450e9 and rec.bottleneck == "collective"
    assert rec.peak_bytes == 15.0
    assert rec.useful_ratio == roofline.model_flops(cfg, shape) / 256 / 2e12
    path = roofline.save_record(rec, str(tmp_path))
    assert os.path.basename(path) == "qwen3-1.7b__train_4k__single__baseline.json"
    assert roofline.load_records(str(tmp_path)) == [rec]
    assert "qwen3-1.7b" in rec.summary()


# -- the collectives -----------------------------------------------------------------------


def _per_position(mesh_shape, names, fn):
    m = tmesh._mk(mesh_shape, names, device="cpu")
    return run_positions(m, fn)


@pytest.mark.parametrize("tiled", [False, True])
@pytest.mark.parametrize("split_axis,concat_axis", [(0, 0), (0, 1), (1, 0), (2, 1)])
def test_all_to_all_against_numpy(split_axis, concat_axis, tiled):
    n = 4
    rng = np.random.default_rng(split_axis * 7 + concat_axis)
    shape = [3, 5, 2]
    shape[split_axis] = n * (2 if tiled else 1)
    xs = [rng.normal(size=shape).astype(np.float32) for _ in range(2 * n)]

    def body(linear):
        return all_to_all(torch.from_numpy(xs[linear]), "model", split_axis, concat_axis,
                          tiled=tiled)

    outs = _per_position((2, n), ("data", "model"), body)
    for d in range(2):
        group = xs[d * n:(d + 1) * n]
        for j in range(n):
            blocks = [np.split(x, n, axis=split_axis)[j] for x in group]
            if tiled:
                want = np.concatenate(blocks, axis=concat_axis)
            else:
                want = np.stack([b.squeeze(split_axis) for b in blocks], axis=concat_axis)
            np.testing.assert_array_equal(outs[d * n + j].numpy(), want)


def test_all_to_all_refuses_a_split_that_does_not_fit():
    with pytest.raises(RuntimeError) as e:
        _per_position((3,), ("model",), lambda i: all_to_all(torch.zeros(4, 2), "model", 0, 0))
    assert "split_axis 0 has size 4" in str(e.value.__cause__)
    with pytest.raises(RuntimeError) as e:
        _per_position((3,), ("model",),
                      lambda i: all_to_all(torch.zeros(4, 2), "model", 0, 0, tiled=True))
    assert "does not split" in str(e.value.__cause__)


def test_pmean_against_numpy():
    rng = np.random.default_rng(1)
    xs = rng.normal(size=(8, 6)).astype(np.float32)
    outs = _per_position((2, 4), ("data", "model"),
                         lambda i: pmean({"x": torch.from_numpy(xs[i])}, "model"))
    for i, out in enumerate(outs):
        d = i // 4
        np.testing.assert_allclose(out["x"].numpy(), xs[4 * d:4 * d + 4].mean(0), rtol=1e-6)
    both = _per_position((2, 4), ("data", "model"),
                         lambda i: pmean(torch.from_numpy(xs[i]), ("data", "model")))
    np.testing.assert_allclose(both[5].numpy(), xs.mean(0), rtol=1e-6, atol=1e-7)


# -- the collective recorder ---------------------------------------------------------------

# tests/test_hlo_parser.py's module: the parser's numbers are the rules the
# recorder follows
HLO = """
HloModule test
%all-reduce.216 = f32[4,512,2048]{2,1,0} all-reduce(%fusion.5), channel_id=1, replica_groups=[8,8]<=[64], use_global_device_ids=true, to_apply=%add
%ag = bf16[64,128]{1,0} all-gather(%p0), channel_id=2, replica_groups=[4,4]<=[16], dimensions={0}
%rs = f32[16,128]{1,0} reduce-scatter(%p1), channel_id=3, replica_groups=[2,8]<=[16], to_apply=%add
%cp = f32[32]{0} collective-permute(%p2), source_target_pairs={{0,1},{1,0}}
%ard = f32[4]{0} all-reduce-done(%h)
%tuple_ar = (f32[128]{0}, f32[128]{0}) all-reduce(%a, %b), replica_groups=[1,4]<=[4], to_apply=%add
"""


def test_hlo_parser_copy_parses_ops_and_bytes():
    s = collective_bytes_from_hlo(HLO)
    ar = 4 * 512 * 2048 * 4 + 2 * 128 * 4
    assert s.bytes_by_op["all-reduce"] == ar
    assert s.count_by_op["all-reduce"] == 2
    assert s.bytes_by_op["all-gather"] == 64 * 128 * 2 / 4
    assert s.bytes_by_op["reduce-scatter"] == 16 * 128 * 4 * 8
    assert s.bytes_by_op["collective-permute"] == 32 * 4
    assert "all-reduce-done" not in " ".join(s.bytes_by_op)
    j = j_collective_bytes(HLO)
    assert (s.bytes_by_op, s.wire_bytes_by_op, s.count_by_op) == \
        (j.bytes_by_op, j.wire_bytes_by_op, j.count_by_op)


def test_hlo_parser_copy_wire_model_is_ring():
    s = collective_bytes_from_hlo(HLO)
    assert abs(s.wire_bytes_by_op["all-gather"] - 64 * 128 * 2 * 3 / 4) < 1e-6


def test_hlo_parser_copy_replica_group_list_form():
    s = collective_bytes_from_hlo(
        "%x = f32[8]{0} all-gather(%p), replica_groups={{0,1,2,3}}, dimensions={0}")
    assert s.bytes_by_op["all-gather"] == 8 * 4 / 4


@pytest.mark.parametrize("op", ["all-reduce", "all-gather", "reduce-scatter"])
def test_recorder_follows_the_parsers_rules(op):
    """Each collective, run over an axis of g positions, records what the
    parser reads off the matching HLO line (operand bytes, ring wire
    bytes, one count)."""
    g = 4
    if op == "all-reduce":
        line = "%o = f32[4,8]{1,0} all-reduce(%p), replica_groups=[2,4]<=[8], to_apply=%add"

        def body(i):
            return psum(torch.zeros(4, 8), "model")
    elif op == "all-gather":
        line = "%o = bf16[64,128]{1,0} all-gather(%p), replica_groups=[2,4]<=[8], dimensions={0}"

        def body(i):
            return all_gather(torch.zeros(16, 128, dtype=torch.bfloat16), "model", tiled=True)
    else:
        line = "%o = f32[4,128]{1,0} reduce-scatter(%p), replica_groups=[2,4]<=[8], to_apply=%add"

        def body(i):
            return psum_scatter(torch.zeros(16, 128), "model", tiled=True)
    want = collective_bytes_from_hlo(line)
    with record_collectives() as rec:
        _per_position((2, g), ("data", "model"), body)
    for linear in range(2 * g):
        assert rec.stats(linear) == want, (op, linear)
    assert rec.mean(2 * g) == want


def test_positions_run_under_the_callers_modes():
    """Grad mode, the recorder and in_positions contexts reach the
    positions' threads (PyTorch keeps grad mode per thread)."""
    entered = []

    class Mark:
        def __enter__(self):
            entered.append(axis_index("model"))

        def __exit__(self, *exc):
            return False

    m = tmesh._mk((1, 2), ("data", "model"), device="cpu")
    with torch.no_grad(), in_positions(Mark):
        seen = run_positions(m, lambda i: torch.is_grad_enabled())
    assert seen == [False, False] and sorted(entered) == [0, 1]
    assert run_positions(m, lambda i: torch.is_grad_enabled()) == [True, True]
    with torch.inference_mode():
        assert run_positions(m, lambda i: torch.is_inference_mode_enabled()) == [True, True]
    f = shard_map(lambda x: x * 2, mesh=m, in_specs=P("model"), out_specs=P("model"))
    x = torch.ones(4, requires_grad=True)
    f(x).sum().backward()
    assert torch.equal(x.grad, torch.full((4,), 2.0))


# -- cells and the dry run -----------------------------------------------------------------

CELLS = [("qwen3-1.7b", "train", {}), ("mamba2-2.7b", "decode", {}),
         ("moonshot-v1-16b-a3b", "train", {}), ("moonshot-v1-16b-a3b", "train",
                                                 {"moe_impl": "ep"})]


@pytest.mark.parametrize("arch,kind,over", CELLS,
                         ids=["qwen3-train", "mamba2-decode", "moonshot-train", "moonshot-ep-train"])
def test_meta_cell_allocates_nothing_and_counts_a_cpu_run(arch, kind, over):
    """tests/test_dryrun_mini.py's cells on a (4, 2) mesh: the meta cell's
    model, inputs and step outputs are all meta tensors, and its counted
    flops, bytes and collectives are a CPU run's of the same cell."""
    cfg = configs.smoke_config(configs.get_arch(arch)).replace(dtype="bfloat16", **over)
    shape = ShapeSpec("mini", 64, 8, kind)
    m = tmesh._mk((4, 2), ("data", "model"))
    meta = build_cell(cfg, shape, m, device="meta")
    cpu = build_cell(cfg, shape, m, device="cpu", generator=torch.Generator().manual_seed(0))
    assert all(t.device.type == "meta" for t in meta.model.parameters())
    assert all(t.device.type == "meta" for t in tree_leaves(list(meta.args)))
    assert meta.param_count == cpu.param_count and meta.local_bytes == cpu.local_bytes
    abstract = abstract_params(cpu.model)
    assert all(t.is_meta for t in abstract.values())
    assert {k: (v.shape, v.dtype) for k, v in abstract.items()} == \
        {k: (v.shape, v.dtype) for k, v in meta.args[0].items()}
    out_meta, count_meta, rec_meta = roofline.count_step(meta)
    assert all(t.device.type == "meta" for t in tree_leaves(out_meta)
               if isinstance(t, torch.Tensor))
    _, count_cpu, rec_cpu = roofline.count_step(cpu)
    assert count_meta.flops > 0 and count_meta.bytes > 0
    for key in ("flops", "bytes", "position_flops", "position_bytes"):
        assert getattr(count_meta, key) == getattr(count_cpu, key), key
    assert rec_meta.by_position == rec_cpu.by_position
    assert bool(rec_meta.by_position) == (over.get("moe_impl") == "ep")
    if kind == "train":
        # the optimizer state is two fp32 moments of each parameter
        fp32 = {k: v.float() for k, v in meta.args[0].items()}
        assert meta.local_bytes["opt"] == 2 * sh.local_bytes(fp32, meta.specs["params"], m)
    metrics = roofline.extract_metrics(meta)
    assert metrics["temp_bytes"] == 0 and metrics["flops"] == pytest.approx(
        (count_meta.flops + count_meta.position_flops) / 8)


def test_cell_steps_match_the_plain_steps():
    """A CPU prefill cell's step is the model's forward on its inputs."""
    cfg = configs.smoke_config(configs.get_arch("qwen3-1.7b"))
    m = tmesh._mk((2, 1), ("data", "model"))
    cell = build_cell(cfg, ShapeSpec("mini", 16, 2, "prefill"), m, device="cpu",
                      generator=torch.Generator().manual_seed(1))
    params, batch = cell.args
    assert params is not None and batch["tokens"].dtype == torch.int32
    logits = cell.step(*cell.args)
    assert logits.shape == (2, 16, cfg.vocab)
    torch.testing.assert_close(logits, cell.model.forward(batch), rtol=0, atol=0)


def test_dryrun_writes_records_and_skips(tmp_path, monkeypatch):
    """run_cell on a smoke config over the 256-position production mesh, on
    meta; an encoder's decode cell writes a skip file."""
    name = "qwen3-1.7b"
    monkeypatch.setitem(configs.ARCHS, name, configs.smoke_config(configs.get_arch(name)))
    rec = dryrun.run_cell(name, "prefill_32k", "single", out_dir=str(tmp_path), verbose=False)
    assert rec.n_devices == 256 and rec.mesh == "single" and rec.hlo_flops > 0
    assert rec.temp_bytes == 0 and "meta allocates nothing" in rec.note
    assert roofline.load_records(str(tmp_path)) == [rec]
    assert dryrun.run_cell("hubert-xlarge", "decode_32k", "single", out_dir=str(tmp_path),
                           verbose=False) is None
    assert (tmp_path / "hubert-xlarge__decode_32k__single__baseline.skip.json").is_file()


def test_dryrun_main_imports_no_jax(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    env.pop("XLA_FLAGS", None)
    code = ("import os, sys; from repro_torch.launch import dryrun; "
            "assert 'jax' not in sys.modules and 'XLA_FLAGS' not in os.environ; "
            "print(dryrun.main(['--arch', 'hubert-xlarge', '--shape', 'decode_32k', "
            f"'--no-probes', '--out', {str(tmp_path)!r}]))")
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "SKIP hubert-xlarge" in out.stdout


def test_cell_local_bytes_follow_the_specs():
    cfg = configs.smoke_config(configs.get_arch("qwen3-1.7b"))
    m = tmesh._mk((4, 2), ("data", "model"))
    cell = build_cell(cfg, ShapeSpec("mini", 64, 8, "prefill"), m, device="meta")
    want = 0
    for (_, x), s in zip(tree_flatten_with_paths(cell.args[0]),
                         sh._spec_leaves(cell.specs["params"])):
        n = math.prod(m.shape[a] for a in s if a is not None)
        want += x.numel() * x.element_size() // n
    assert cell.local_bytes["params"] == want < cell.param_bytes
    assert cell.local_bytes["batch"] == 8 * 64 * 4 // 4
