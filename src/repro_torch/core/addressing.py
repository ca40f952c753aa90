"""DSM shared-memory address space (paper §5.1), kept for the host directory.

STEP interprets a 64-bit shared-memory address as a high-order 32-bit
``object_id`` plus a low-order 32-bit ``field_id``; the DSM is organised in
32-bit *words*, and coarse-grained mode groups 32 consecutive words into a
*package* stored behind one KV pair, with package-aligned addressing.

On TPU the physical transport is ICI collectives rather than memcached RTTs,
but the layout policy survives: the package becomes a 128-element lane-aligned
tile (the TPU minor-dim tile), and "coarse-grained DSM" becomes fusing pytree
leaves into package-aligned flat buffers so each collective moves few, large,
aligned blocks (see :mod:`repro.core.dsm`).
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

# --- paper constants (§5.1) -------------------------------------------------
WORD_BYTES = 4            # DSM word = 32 bits
PACKAGE_WORDS = 32        # words per coarse-grained package
OBJECT_ID_BITS = 32       # default x in the paper
FIELD_ID_BITS = 64 - OBJECT_ID_BITS
GLOBALS_OBJECT_ID = 0     # virtual object holding all shared variables

# --- TPU adaptation ----------------------------------------------------------
# The TPU native minor-most tile is 128 lanes; a "package" on TPU is therefore
# 128 elements so packed buffers start on lane boundaries and collectives /
# DMA see aligned blocks. (For 4-byte words that is 512B, i.e. 4 paper packages.)
TPU_PACKAGE_ELEMS = 128


def make_address(object_id: int, field_id: int) -> int:
    """Compose the 64-bit DSM address ``object_id ++ field_id``."""
    if not (0 <= object_id < (1 << OBJECT_ID_BITS)):
        raise ValueError(f"object_id out of range: {object_id}")
    if not (0 <= field_id < (1 << FIELD_ID_BITS)):
        raise ValueError(f"field_id out of range: {field_id}")
    return (object_id << FIELD_ID_BITS) | field_id


def split_address(addr: int) -> tuple[int, int]:
    """Inverse of :func:`make_address`."""
    return addr >> FIELD_ID_BITS, addr & ((1 << FIELD_ID_BITS) - 1)


def package_id(addr: int) -> int:
    """Package (coarse block) index of an address — paper: addr words / 32."""
    return addr // PACKAGE_WORDS


def block_address(addr: int) -> int:
    """High-order 59 bits: address of the owning 32-word cache/data block."""
    return addr >> 5


def watcher_node(addr: int, n_nodes: int) -> int:
    """Directory owner for a block: node_id == block_address (mod n)  (§5.1)."""
    return block_address(addr) % n_nodes


def ring_hash(key) -> int:
    """Stable 64-bit ring position of a DSM key (a name or a block address).

    The paper's ``node_id ≡ block_address (mod n)`` assignment reshuffles
    *every* block when ``n`` changes; the sharded store instead places keys on
    a consistent-hash ring, so a shard join/leave moves only the ~1/S of keys
    whose arc changed owner.  ``blake2b`` keeps the placement stable across
    processes (Python's built-in ``hash`` is salted per run), which is what
    lets a recovered session adopt a surviving store without re-hashing it.
    """
    if isinstance(key, int):
        data = key.to_bytes(8, "little", signed=False)
    else:
        data = str(key).encode("utf-8")
    return int.from_bytes(hashlib.blake2b(data, digest_size=8).digest(), "big")


def align_up(n: int, multiple: int) -> int:
    return ((n + multiple - 1) // multiple) * multiple


@dataclass(frozen=True)
class FieldSlot:
    """Directory record: where a named field lives inside the DSM space."""

    object_id: int
    field_id: int
    num_words: int

    @property
    def address(self) -> int:
        return make_address(self.object_id, self.field_id)


class AddressAllocator:
    """Allocates object ids and package-aligned field offsets.

    Coarse-grained mode guarantees package-size-aligned shared-memory
    addresses (paper §5.1); fine-grained mode packs fields densely.
    """

    def __init__(self, coarse: bool = True):
        self.coarse = coarse
        self._next_object = GLOBALS_OBJECT_ID + 1
        self._next_field: dict[int, int] = {GLOBALS_OBJECT_ID: 0}

    def new_object(self) -> int:
        oid = self._next_object
        self._next_object += 1
        self._next_field[oid] = 0
        return oid

    def alloc_field(self, object_id: int, num_words: int) -> FieldSlot:
        cur = self._next_field.setdefault(object_id, 0)
        if self.coarse:
            cur = align_up(cur, PACKAGE_WORDS)
        slot = FieldSlot(object_id, cur, num_words)
        self._next_field[object_id] = cur + num_words
        return slot
