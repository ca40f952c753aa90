"""``BENCHMARK.json`` against the benchmark's contract, and the result line's
schema from a run on the CPU."""

import json
import re

import pytest

from stepbench import manifest
from stepbench.runner import run_cell
from stepbench.tests.small import SEED, SMALL

ROOT = manifest.HERE.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
TEXT = re.compile(r"^[^\n\t]{1,200}$")
BENCH = manifest.benchmark(ROOT)


def test_top_level_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= len(BENCH["command"]) <= 32
    assert all(TEXT.match(w) for w in BENCH["command"])
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and ".." not in p and not p.startswith("/")
        assert (ROOT / p).is_dir()
    script = BENCH["command"][1]
    assert any(script.startswith(p + "/") for p in BENCH["paths"])
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_configs():
    used = {w["config"] for w in BENCH["workloads"]}
    assert 1 <= len(BENCH["configs"]) <= 24
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] in used
        assert TEXT.match(c["source"]) and TEXT.match(c["why"])
        assert any(c["file"].startswith(p + "/") for p in BENCH["paths"])
        cfg = manifest.load_json(ROOT / c["file"])
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        for kind, name in (("apps", cfg["app"]), ("generators", cfg["generator"]),
                           ("reference", cfg["app"]), ("roofline", c["name"])):
            assert (manifest.HERE / kind / f"{name}.py").is_file()
        assert cfg["limits"]


def test_workloads():
    configs = {c["name"] for c in BENCH["configs"]}
    assert 1 <= len(BENCH["workloads"]) <= 24
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert TEXT.match(w["why"])
        assert (manifest.HERE / "traffic" / f"{w['traffic']}.json").is_file()
        pairs.add((w["config"], w["traffic"]))
    assert len(pairs) == len(BENCH["workloads"])
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, len(pairs) // 4)


def test_metrics():
    e2e, layers = BENCH["end_to_end"], BENCH["per_layer"]
    names = [m["name"] for m in e2e + layers]
    assert len(names) == len(set(names))
    assert 1 <= len(e2e) <= 16 and 1 <= len(layers) <= 128
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in e2e:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in e2e)
    e2e_names = {m["name"] for m in e2e}
    for m in layers:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer",
                                          "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter",
                               "host_clock")
        assert m["moves"] in e2e_names and TEXT.match(m["layer"])
    for m in e2e + layers:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
        assert (manifest.HERE / "metrics" / f"{m['name']}.py").is_file()
    for cell in cells:
        reported = {m["name"] for m in manifest.metrics_of(BENCH, "end_to_end", cell)}
        assert "setup_s" in reported and len(reported) >= 2
        assert manifest.metrics_of(BENCH, "per_layer", cell)
        for m in manifest.metrics_of(BENCH, "per_layer", cell):
            assert m["moves"] in reported


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("workload", sorted(SMALL))
def test_result_line(workload, trace):
    result = run_cell(workload, SEED, 0.2, bool(trace), root=ROOT, device="cpu",
                      overrides=SMALL[workload])
    line = json.loads(json.dumps(result.line()))
    keys = list(line)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert keys[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 1
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    section = "per_layer" if trace else "end_to_end"
    allowed = {m["name"]: m["unit"] for m in manifest.metrics_of(BENCH, section, workload)}
    assert line["metrics"] and set(line["metrics"]) <= set(allowed)
    for name, m in line["metrics"].items():
        assert set(m) == {"value", "unit"} and m["unit"] == allowed[name]
    if trace:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert all(len(v) <= 10 for v in line["breakdown"].values())
    else:
        assert {"iter_ms", "setup_s"} <= set(line["metrics"])
    limits = manifest.config(BENCH, ROOT, manifest.cell(BENCH, workload)["config"])["limits"]
    assert set(line["checks"]) == set(limits)
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]
