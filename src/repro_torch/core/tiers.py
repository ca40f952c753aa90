"""step.tiers — pluggable cold storage beneath the sharded DSM (port of
:mod:`repro.core.tiers`).

A :class:`ColdTier` holds opaque *value payloads* keyed by DSM name; every
entry's metadata (epoch, delete-era generation, address slot) stays on the
owning :class:`~repro_torch.core.shards.Shard`, so validation and coherence
never touch the cold backend.  Two backends ship:

* :class:`HostMemTier` — an in-process dict of CPU tensors: a demoted entry
  leaves the card's memory for the host's.
* :class:`DiskTier` — one pickled payload per name under a spill directory,
  the file named by a digest of the DSM name (the JAX package's names, so a
  name maps to the same spill file in both packages).

A payload is a CPU tensor, or a dict of them for a shared object: numpy has
no bfloat16, and a bf16 entry must come back bit for bit.  Demotion copies
each leaf to the host with a blocking ``.to("cpu")`` — the payload is whole
before the store drops its device tensor — and promotion copies it back to
the store's device.  Both backends are thread-safe behind one leaf lock (tier
calls run under the owning shard's lock and never call back into the store).

``resolve_cold_tier`` maps the ``Session(cold_tier=...)`` argument
(``"host" | "disk" | ColdTier instance | None``) onto a backend instance.
"""

from __future__ import annotations

import hashlib
import os
import pickle
import shutil
import tempfile
import threading
from typing import Any, Dict, Optional, Protocol, runtime_checkable


def _leaves(value) -> list:
    """The tensors of a value: a tensor, a dict of them, or None (a demoted
    entry, which holds no payload)."""
    if value is None:
        return []
    return list(value.values()) if isinstance(value, dict) else [value]


def host_payload(value: Any) -> Any:
    """A store value (a tensor, or a dict of tensor fields) as CPU tensors —
    the representation every cold backend stores.  A leaf already on the
    CPU is kept as is: stored values are never written in place."""
    if isinstance(value, dict):
        return {k: v.to("cpu") for k, v in value.items()}
    return value.to("cpu")


def payload_nbytes(value: Any) -> int:
    """Size of a value or payload in bytes (the unit of tier budgets and
    stats): ``numel × element_size`` summed over its leaves."""
    return int(sum(t.numel() * t.element_size() for t in _leaves(value)))


def _fresh_tier_stats() -> Dict[str, int]:
    return {"puts": 0, "gets": 0, "deletes": 0, "entries": 0, "bytes": 0}


@runtime_checkable
class ColdTier(Protocol):
    """Where demoted value payloads live.  Keys are DSM names (unique across
    the store, so a payload never needs re-keying when its entry migrates
    between shards).  Implementations must be thread-safe and must not call
    back into store or cache code (tier locks are leaves)."""

    kind: str

    def put(self, name: str, value: Any) -> int:
        """Store ``value`` under ``name``; returns the number of bytes now
        held for the name (replacing any previous payload)."""
        ...

    def get(self, name: str) -> Any:
        """Load the payload for ``name`` (KeyError if absent)."""
        ...

    def delete(self, name: str) -> None:
        """Drop the payload for ``name`` (no-op if absent)."""
        ...

    def stats(self) -> Dict[str, int]:
        """``{"puts", "gets", "deletes", "entries", "bytes"}`` counters."""
        ...

    def close(self) -> None:
        """Release backend resources (spill files, handles)."""
        ...


class HostMemTier:
    """In-process host-memory cold tier: a dict of CPU tensor payloads."""

    kind = "host"

    def __init__(self):
        self._lock = threading.Lock()
        self._data: Dict[str, Any] = {}
        self._sizes: Dict[str, int] = {}
        self._stats = _fresh_tier_stats()

    def put(self, name: str, value: Any) -> int:
        payload = host_payload(value)
        nb = payload_nbytes(payload)
        with self._lock:
            self._stats["bytes"] += nb - self._sizes.get(name, 0)
            if name not in self._data:
                self._stats["entries"] += 1
            self._data[name] = payload
            self._sizes[name] = nb
            self._stats["puts"] += 1
        return nb

    def get(self, name: str) -> Any:
        with self._lock:
            self._stats["gets"] += 1
            return self._data[name]

    def delete(self, name: str) -> None:
        with self._lock:
            if name in self._data:
                del self._data[name]
                self._stats["entries"] -= 1
                self._stats["bytes"] -= self._sizes.pop(name)
                self._stats["deletes"] += 1

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._stats)

    def close(self) -> None:
        with self._lock:
            self._data.clear()
            self._sizes.clear()

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"HostMemTier(entries={self._stats['entries']})"


class DiskTier:
    """On-disk cold tier: one pickled payload per name under ``root``.

    File names are a 160-bit blake2b digest of the full DSM name, so any name
    maps onto the filesystem safely and two live names never share a spill
    file.  ``root=None`` spills into a fresh temporary directory, removed on
    :meth:`close`."""

    kind = "disk"

    def __init__(self, root: Optional[str] = None):
        self._owns_root = root is None
        self.root = root or tempfile.mkdtemp(prefix="step-cold-")
        os.makedirs(self.root, exist_ok=True)
        self._lock = threading.Lock()
        self._paths: Dict[str, str] = {}
        self._sizes: Dict[str, int] = {}
        self._stats = _fresh_tier_stats()

    def _path(self, name: str) -> str:
        digest = hashlib.blake2b(str(name).encode("utf-8"),
                                 digest_size=20).hexdigest()
        return os.path.join(self.root, f"{digest}.pkl")

    def put(self, name: str, value: Any) -> int:
        payload = host_payload(value)
        nb = payload_nbytes(payload)
        path = self._path(name)
        blob = pickle.dumps(payload, protocol=pickle.HIGHEST_PROTOCOL)
        with self._lock:
            with open(path, "wb") as fh:
                fh.write(blob)
            self._stats["bytes"] += nb - self._sizes.get(name, 0)
            if name not in self._paths:
                self._stats["entries"] += 1
            self._paths[name] = path
            self._sizes[name] = nb
            self._stats["puts"] += 1
        return nb

    def get(self, name: str) -> Any:
        with self._lock:
            path = self._paths[name]
            self._stats["gets"] += 1
            with open(path, "rb") as fh:
                return pickle.load(fh)

    def delete(self, name: str) -> None:
        with self._lock:
            path = self._paths.pop(name, None)
            if path is None:
                return
            self._stats["entries"] -= 1
            self._stats["bytes"] -= self._sizes.pop(name)
            self._stats["deletes"] += 1
            try:
                os.unlink(path)
            except FileNotFoundError:  # pragma: no cover - already gone
                pass

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._stats)

    def close(self) -> None:
        with self._lock:
            self._paths.clear()
            self._sizes.clear()
            if self._owns_root:
                shutil.rmtree(self.root, ignore_errors=True)

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"DiskTier(root={self.root!r}, entries={self._stats['entries']})"


def resolve_cold_tier(cold_tier) -> Optional[ColdTier]:
    """Map the ``cold_tier=`` constructor argument onto a backend: ``None``
    keeps the store single-tier, ``"host"``/``"disk"`` build the bundled
    backends, and any :class:`ColdTier`-shaped object is adopted as is."""
    if cold_tier is None:
        return None
    if isinstance(cold_tier, str):
        if cold_tier == "host":
            return HostMemTier()
        if cold_tier == "disk":
            return DiskTier()
        raise ValueError(
            f"cold_tier must be None, 'host', 'disk' or a ColdTier instance, "
            f"got {cold_tier!r}")
    if isinstance(cold_tier, ColdTier):
        return cold_tier
    raise TypeError(f"not a ColdTier: {cold_tier!r} (needs put/get/delete/"
                    "stats/close and a kind attribute)")
