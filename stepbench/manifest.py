"""``BENCHMARK.json`` and the files it names, found by name.

Everything that belongs to one configuration, traffic mix or metric sits in
a file of its own, so that a cell, a configuration or a metric is added by
adding files and entries, never by editing one:

* a configuration: its JSON file (``configs`` entry ``file``), which names
  its ``app`` (``apps/<app>.py``, whose plain reference is
  ``reference/<app>.py``) and its ``generator`` (``generators/<name>.py``);
  its roofline counts are ``roofline/<config>.py``;
* a traffic mix: ``traffic/<traffic>.json``;
* a metric, end to end or per layer: ``metrics/<metric>.py``, a reader with
  ``read(obs)`` that returns the value or None.
"""

from __future__ import annotations

import importlib.util
import json
import re
import sys
from pathlib import Path
from types import ModuleType

HERE = Path(__file__).resolve().parent


class ManifestError(RuntimeError):
    pass


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path) -> dict:
    path = root / "BENCHMARK.json"
    if not path.is_file():
        raise ManifestError(f"no BENCHMARK.json at {root}")
    return load_json(path)


def _named(entries, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise ManifestError(f"no {what} named {name!r} in BENCHMARK.json")


def cell(manifest: dict, workload: str) -> dict:
    return _named(manifest["workloads"], workload, "workload")


def config(manifest: dict, root: Path, name: str) -> dict:
    return load_json(root / _named(manifest["configs"], name, "config")["file"])


def traffic(name: str) -> dict:
    return load_json(HERE / "traffic" / f"{name}.json")


def metrics_of(manifest: dict, section: str, workload: str) -> list:
    """The entries of ``section`` (``end_to_end`` or ``per_layer``) that the
    cell reports: those without ``workloads``, and those that list it."""
    return [m for m in manifest[section]
            if "workloads" not in m or workload in m["workloads"]]


def module(kind: str, name: str) -> ModuleType:
    """``<kind>/<name>.py`` under the benchmark, imported once."""
    path = HERE / kind / f"{name}.py"
    if not path.is_file():
        raise ManifestError(f"no {kind} file {path.relative_to(HERE.parent)}")
    mod_name = f"stepbench.{kind}.{re.sub(r'[^0-9A-Za-z_]', '_', name)}"
    mod = sys.modules.get(mod_name)
    if mod is None:
        spec = importlib.util.spec_from_file_location(mod_name, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[mod_name] = mod
        spec.loader.exec_module(mod)
    return mod
