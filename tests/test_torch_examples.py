"""The port's host-path examples run on the CPU (``--device cpu``) in
subprocesses: logistic regression and PageRank put as many elements on the
wire as repro's examples print for the same runs, and name the branch each
accumulator took; the serving example generates zamba2-2.7b's tokens."""

import os
import re
import subprocess
import sys

import pytest

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
WIRE = re.compile(r"wire\s+(\d+) elems")


def _run(script, *args):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="1",
               JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, os.path.join(ROOT, "examples", script), *args],
                          cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return proc.stdout


@pytest.mark.parametrize("name,branches", [
    ("logistic_regression", ["gather_all", "reduce_scatter", "reduce_scatter"]),
    ("pagerank_graph", ["gather_all", "reduce_scatter", "sparse"])])
def test_app_example_wire_as_repros(name, branches):
    ours = _run(f"torch_{name}.py", "--device", "cpu")
    theirs = _run(f"{name}.py")
    assert WIRE.findall(ours) == WIRE.findall(theirs) and WIRE.findall(ours)
    assert re.findall(r"branch (\w+)", ours) == branches


def test_serve_example_generates_zamba2_tokens():
    out = _run("torch_serve_lm.py", "--arch", "zamba2-2.7b", "--device", "cpu",
               "--batch", "2", "--prompt-len", "5", "--gen", "6")
    assert "[serve] prefill 5 toks" in out
    assert re.search(r"\[serve_lm\] generated 2×6 tokens; first request: \[(\d+, ){5}\d+\]", out)
