"""A configuration, a traffic mix and a metric reader added as new files,
with entries added to ``BENCHMARK.json``, are picked up with no file of the
benchmark edited."""

import json
import shutil
import os
import subprocess
import sys

from stepbench import manifest

ROOT = manifest.HERE.parent
ONE_THREAD = {**os.environ, "OMP_NUM_THREADS": "1"}


def test_new_files_are_picked_up(tmp_path):
    shutil.copytree(manifest.HERE, tmp_path / "stepbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p.relative_to(tmp_path): p.read_bytes()
              for p in (tmp_path / "stepbench").rglob("*") if p.is_file()}
    bench = manifest.benchmark(ROOT)
    cfg = manifest.load_json(ROOT / "stepbench" / "configs" / "pagerank-g500.json")
    cfg.update(name="pagerank-tiny", graph={**cfg["graph"], "scale": 9})
    (tmp_path / "stepbench" / "configs" / "pagerank-tiny.json").write_text(json.dumps(cfg))
    (tmp_path / "stepbench" / "roofline" / "pagerank-tiny.py").write_text(
        (ROOT / "stepbench" / "roofline" / "pagerank-g500.py").read_text())
    (tmp_path / "stepbench" / "traffic" / "auto-i3.json").write_text(
        json.dumps({"loop": "closed", "clients": 1, "iters": 3, "mode": "auto"}))
    (tmp_path / "stepbench" / "metrics" / "jobs_done.py").write_text(
        "def read(obs):\n    return obs.jobs\n")
    bench["configs"].append({"name": "pagerank-tiny", "source": "a test",
                             "file": "stepbench/configs/pagerank-tiny.json",
                             "reduced": ["graph"], "why": "a test"})
    bench["workloads"].append({"name": "pagerank-tiny.i3", "config": "pagerank-tiny",
                               "traffic": "auto-i3", "chips": 1, "why": "a test"})
    bench["end_to_end"].append({"name": "jobs_done", "unit": "jobs", "better": "higher",
                                "bound": 0.25, "source": "host_clock",
                                "workloads": ["pagerank-tiny.i3"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = (
        "import json, sys; from pathlib import Path\n"
        f"sys.path[:0] = [{str(tmp_path)!r}, {str(ROOT / 'src')!r}]\n"
        "import stepbench\n"
        f"assert Path(stepbench.__file__).parent == Path({str(tmp_path)!r}) / 'stepbench'\n"
        "from stepbench.runner import run_cell\n"
        f"r = run_cell('pagerank-tiny.i3', 5, 0.2, False, root=Path({str(tmp_path)!r}),"
        " device='cpu')\n"
        "print(json.dumps(r.line()))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=ONE_THREAD,
                         timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    assert line["metrics"]["jobs_done"]["value"] >= 1
    assert {"iter_ms", "setup_s", "jobs_done"} <= set(line["metrics"])
    after = {p.relative_to(tmp_path): p.read_bytes()
             for p in (tmp_path / "stepbench").rglob("*")
             if p.is_file() and "__pycache__" not in p.parts}
    assert all(after[k] == v for k, v in before.items())
