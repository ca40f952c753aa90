"""``abs(default_rng(seed).normal(size=...))`` as float32, drawn on the card.

nmf's initial P and Q are part of its result: the JAX package draws them
with numpy's ``Generator.normal`` (PCG64 words through a 256-layer
ziggurat, in float64), and the tests hold the port's trajectories to it.
``csrc/nmf_init.cu`` produces the same numbers on the card, bit for bit:

* the seed goes through numpy's own ``PCG64(seed)`` (its SeedSequence) on
  the host, and the kernels jump the 128-bit LCG ahead to any position;
* the ziggurat's tables ``ki``, ``wi`` and ``fi`` are numpy's constants
  (:mod:`.ziggurat`), which the tests check against the installed numpy;
* a word is an attempt that returns on the fast path (``rabs < ki[idx]``,
  ``rabs * wi[idx]``) or needs the slow path (the wedge test, one more
  word, or the tail's loop, two words a try).  The kernels find which
  positions start an attempt and which attempts yield a value in parallel
  (:mod:`tests.test_torch_nmf_init` holds a numpy model of the resolution),
  and write each value's ``|x|`` as float32 at its index in the stream:
  P (n, k), then Q (k, m), as ``_init``'s two ``normal`` calls fill them.

The kernels run on CUDA tensors only; the CPU keeps numpy
(``analytics/nmf.py:_init``), which the kernels are held against.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.nmf_init import ziggurat

# PCG64 (XSL-RR 128/64): state <- state * MULT + inc, then the output word
MULT = 0x2360ED051FC65DA44385DF649FCCF645
MASK128 = (1 << 128) - 1
MASK64 = (1 << 64) - 1

THREADS = 256              # a CTA of the classifying kernels
RUN = 16                   # positions a thread, THREADS apart
TILE = THREADS * RUN       # positions a CTA
MAX_WORDS = 2**31 - 2**24  # positions are int32 on the card, with room for a tail's reach

# the tables as the kernels read them: 768 uint64 words, ki, then the bits
# of wi, then of fi
TABLES = np.array(ziggurat.KI + ziggurat.WI + ziggurat.FI, dtype=np.uint64)
KI = TABLES[:256]
WI = TABLES[256:512].view(np.float64)
FI = TABLES[512:].view(np.float64)

launches = build.LaunchCounter("nmf_init")
LAUNCHES_A_DRAW = 6        # count, scan, slow, resolve, scan, write

_SIGNATURES = {
    "nmf_init_count": (build.PTR, build.PTR, build.LONG, build.PTR, build.PTR),
    "nmf_init_scan": (build.PTR, build.INT, build.PTR, build.PTR),
    "nmf_init_slow": (build.PTR, build.PTR, build.LONG, build.PTR, build.INT, build.PTR,
                      build.PTR, build.PTR),
    "nmf_init_resolve": (build.PTR, build.INT, build.PTR, build.PTR, build.PTR),
    "nmf_init_write": (build.PTR, build.PTR, build.LONG, build.PTR, build.INT, build.PTR,
                       build.PTR, build.PTR, build.LONG, build.PTR, build.LONG, build.PTR,
                       build.PTR),
}

_on_device: dict = {}       # device -> TABLES on it


def jump(delta: int, inc: int) -> Tuple[int, int]:
    """``(mult, plus)`` with ``state_{j + delta} = mult * state_j + plus``."""
    acc_m, acc_p, cur_m, cur_p = 1, 0, MULT, inc
    while delta:
        if delta & 1:
            acc_m = acc_m * cur_m & MASK128
            acc_p = (acc_p * cur_m + cur_p) & MASK128
        cur_p = (cur_m + 1) * cur_p & MASK128
        cur_m = cur_m * cur_m & MASK128
        delta >>= 1
    return acc_m, acc_p


def seeded(seed: int) -> Tuple[int, int]:
    """``(state, inc)`` of ``np.random.PCG64(seed)``: numpy's own seeding."""
    st = np.random.PCG64(seed).state["state"]
    return int(st["state"]), int(st["inc"])


def _device_tables(device: torch.device) -> torch.Tensor:
    t = _on_device.get(device)
    if t is None:
        t = _on_device.setdefault(device, torch.from_numpy(TABLES.view(np.int64)).to(device))
    return t


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


def word_budget(n_values: int) -> int:
    """Words the kernels classify for ``n_values`` values: about 2.2% of a
    stream's words yield nothing, so N/16 + 4,096 more leave a shortfall
    (flagged, never silent) out of reach."""
    return n_values + n_values // 16 + 4096


def slow_capacity(n_words: int) -> int:
    """Room for the words that take the slow path: 1.49% of a stream's."""
    return n_words // 32 + 4096


def stream_params(state: int, inc: int) -> np.ndarray:
    """The kernels' view of the stream, 8 uint64: the state, ``inc`` and
    the map of :data:`THREADS` steps (mult, plus), each low word first."""
    m, p = jump(THREADS, inc)
    return np.array([w for x in (state, inc, m, p) for w in (x & MASK64, x >> 64)],
                    dtype=np.uint64)


def abs_normals(n: int, m: int, k: int, state: int, inc: int, device: torch.device
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """float32 tensors P (n, k) and Q (k, m) on ``device`` (the card)
    holding ``abs(g.normal(size=(n, k)))`` and then ``abs(g.normal(size=(k,
    m)))`` for ``g`` a Generator whose PCG64 stands at ``(state, inc)``, and
    a (1,) int32 flag that reads 1 once every value is written (0 only if
    the stream or the slow list's room ran short, which :func:`word_budget`
    and :func:`slow_capacity` put out of reach).  Six launches on the
    current stream, no host sync; int32 scratch of ~5 words a slow-list
    entry (~21 MB at nmf's cell).  Raises ``ValueError`` for a CPU device
    (the CPU draws with numpy) or past :data:`MAX_WORDS` words."""
    sizes = (n * k, k * m)
    n_values = sum(sizes)
    n_words = word_budget(n_values)
    if n_words > MAX_WORDS:
        raise ValueError(f"the card's draw takes int32 positions, below {MAX_WORDS} words: "
                         f"{n_values} values need {n_words}")
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"abs_normals runs on the card, not {device}: the CPU draws with numpy")
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index != torch.cuda.current_device():   # switch devices only where needed
        with torch.cuda.device(index):
            return abs_normals(n, m, k, state, inc, device)
    tab = _device_tables(torch.device("cuda", index))
    cap = slow_capacity(n_words)
    n_tiles = -(-n_words // TILE)
    params = torch.from_numpy(stream_params(state, inc).view(np.int64)).to(device)
    # int32 scratch: the tiles' offsets (then the slow count), the slow
    # table (pos, next, flags, value bits, dex and its total), the largest
    # reach and the done flag
    scratch = torch.empty(n_tiles + 1 + 5 * cap + 3, dtype=torch.int32, device=device)
    offsets, slow, reach, done = scratch.split([n_tiles + 1, 5 * cap + 1, 1, 1])
    reach.fill_(1)
    done.zero_()
    p0 = torch.empty((n, k), dtype=torch.float32, device=device)
    q0 = torch.empty((k, m), dtype=torch.float32, device=device)
    stream = torch.cuda.current_stream(index).cuda_stream
    lib = build.library("nmf_init", _SIGNATURES)

    def run(fn, *args):
        code = getattr(lib, fn)(*args, stream)
        if code:
            build.check(lib, fn, code)
        launches.add()
    p, t, o, sl, r = (x.data_ptr() for x in (params, tab, offsets, slow, reach))
    run("nmf_init_count", p, t, n_words, o)
    run("nmf_init_scan", o, n_tiles, None)
    run("nmf_init_slow", p, t, n_words, o, cap, sl, r)
    run("nmf_init_resolve", offsets[n_tiles:].data_ptr(), cap, sl, r)
    run("nmf_init_scan", slow[4 * cap:].data_ptr(), cap, offsets[n_tiles:].data_ptr())
    run("nmf_init_write", p, t, n_words, o, cap, sl, r, p0.data_ptr(), sizes[0],
        q0.data_ptr(), sizes[1], done.data_ptr())
    return p0, q0, done
