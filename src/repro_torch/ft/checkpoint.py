"""Checkpoint-based recovery — STEP §5.4 (port of :mod:`repro.ft.checkpoint`).

The paper checkpoints a consistent copy of the DSM every few iterations,
right before barrier release; recovery rolls every thread back to the latest
checkpoint.  Here:

* ``save_checkpoint`` persists any tree (see :mod:`repro_torch.utils.tree`)
  to a directory of ``.npy`` leaves plus a JSON manifest, device tensors
  copied to the host first.  The format is the JAX package's, leaf for leaf:
  ``step_XXXXXXXX/leaf_{i:05d}.npy`` in JAX's flattening order, the same
  ``path``/``shape``/``dtype`` records, an atomic ``.tmp`` rename and pruning
  to the newest ``keep``.  A bfloat16 leaf is written as the JAX package
  writes it (two bytes an element, header ``<V2``, manifest ``bfloat16``),
  and read back through a 16-bit view, bit for bit.
* ``restore_checkpoint`` loads the newest (or a given) step into a
  template's structure and places the leaves on ``device`` (the card unless
  the caller asks for the CPU).
* :class:`AsyncCheckpointer` snapshots to the host and writes on a
  background thread; :class:`Checkpoint` is the paper's user hook.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.utils.tree import tree_flatten_with_paths, tree_map, tree_unflatten

_MANIFEST = "manifest.json"
_BF16 = "bfloat16"


def _ckpt_dir(root: str, step: int) -> str:
    return os.path.join(root, f"step_{step:08d}")


def _host_leaf(leaf) -> np.ndarray:
    """A leaf as a host numpy array; bf16 as its raw 16-bit words."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        return t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 else t.numpy()
    return np.asarray(leaf)


def _save_leaf(path: str, leaf) -> tuple:
    """Write one leaf; returns its manifest (shape, dtype)."""
    arr = _host_leaf(leaf)
    if isinstance(leaf, torch.Tensor) and leaf.dtype == torch.bfloat16:
        # the bytes np.save writes for an ml_dtypes bfloat16 array: a '<V2'
        # header, then the 16-bit words
        with open(path, "wb") as fh:
            np.lib.format.write_array_header_1_0(
                fh, {"descr": "<V2", "fortran_order": False, "shape": arr.shape})
            fh.write(np.ascontiguousarray(arr).tobytes())
        return list(arr.shape), _BF16
    np.save(path, arr)
    return list(arr.shape), str(arr.dtype)


def _load_leaf(path: str, dtype: str) -> torch.Tensor:
    arr = np.load(path)
    if dtype == _BF16 or arr.dtype.kind == "V":
        # a 2-byte void leaf is bf16 (numpy has no bfloat16 of its own)
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _dtype_of(template_leaf) -> torch.dtype:
    if isinstance(template_leaf, torch.Tensor):
        return template_leaf.dtype
    return torch.from_numpy(np.empty(0, np.asarray(template_leaf).dtype)).dtype


def save_checkpoint(root: str, step: int, tree: Any, *, extra: Optional[Dict] = None,
                    keep: int = 3) -> str:
    """Atomically persist ``tree`` for ``step``; prune to the newest ``keep``."""
    os.makedirs(root, exist_ok=True)
    final = _ckpt_dir(root, step)
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {"step": step, "time": time.time(), "leaves": [], "extra": extra or {}}
    for i, (path, leaf) in enumerate(tree_flatten_with_paths(tree)):
        fname = f"leaf_{i:05d}.npy"
        shape, dtype = _save_leaf(os.path.join(tmp, fname), leaf)
        manifest["leaves"].append({"path": path, "file": fname,
                                   "shape": shape, "dtype": dtype})
    with open(os.path.join(tmp, _MANIFEST), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _prune(root, keep)
    return final


def _prune(root: str, keep: int) -> None:
    steps = sorted(list_checkpoints(root))
    for s in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(_ckpt_dir(root, s), ignore_errors=True)


def list_checkpoints(root: str):
    if not os.path.isdir(root):
        return []
    out = []
    for d in os.listdir(root):
        if d.startswith("step_") and not d.endswith(".tmp"):
            if os.path.exists(os.path.join(root, d, _MANIFEST)):
                out.append(int(d.split("_")[1]))
    return sorted(out)


def latest_step(root: str) -> Optional[int]:
    steps = list_checkpoints(root)
    return steps[-1] if steps else None


def restore_checkpoint(root: str, template: Any, *, step: Optional[int] = None,
                       device=None):
    """Restore into the structure of ``template`` (a tree of tensors, meta
    tensors or arrays: only shapes and dtypes are read), each leaf cast to
    its template's dtype and placed on ``device`` (``None``: the card).
    Returns ``(tree, manifest_extra, step)``."""
    dev = resolve_device(device)
    if step is None:
        step = latest_step(root)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {root}")
    d = _ckpt_dir(root, step)
    with open(os.path.join(d, _MANIFEST)) as f:
        manifest = json.load(f)
    by_path = {rec["path"]: rec for rec in manifest["leaves"]}

    leaves = []
    for path, tmpl in tree_flatten_with_paths(template):
        rec = by_path.get(path)
        if rec is None:
            raise KeyError(f"checkpoint {d} missing leaf {path}")
        t = _load_leaf(os.path.join(d, rec["file"]), rec["dtype"])
        if tuple(t.shape) != tuple(tmpl.shape):
            raise ValueError(f"{path}: ckpt shape {tuple(t.shape)} != template "
                             f"{tuple(tmpl.shape)}")
        leaves.append(t.to(device=dev, dtype=_dtype_of(tmpl)))
    return tree_unflatten(template, leaves), manifest.get("extra", {}), step


class AsyncCheckpointer:
    """Non-blocking saver: snapshot to the host, write on a background thread."""

    def __init__(self, root: str, keep: int = 3):
        self.root = root
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self.last_saved: Optional[int] = None

    def save(self, step: int, tree: Any, extra: Optional[Dict] = None) -> None:
        self.wait()  # one in flight at a time
        # a copy, so that the caller may go on updating its tensors (in its
        # structure: a namedtuple keeps its field names in the leaves' paths)
        host_tree = tree_map(lambda x: x.detach().to("cpu", copy=True)
                             if isinstance(x, torch.Tensor) else np.array(x), tree)

        def work():
            save_checkpoint(self.root, step, host_tree, extra=extra, keep=self.keep)
            self.last_saved = step

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None


class Checkpoint:
    """Paper §5.4 user hook: extend and override to persist extra program state."""

    def do_checkpoint(self) -> Dict:
        return {}

    def do_restart(self, state: Dict) -> None:
        pass

    # paper-cased aliases
    DoCheckpoint = do_checkpoint
    DoRestart = do_restart
