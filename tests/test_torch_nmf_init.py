"""nmf's initial factors on the card: ``csrc/nmf_init.cu`` against numpy's
``default_rng(seed).normal`` stream.

CPU tests hold the ziggurat tables the kernels take (``ziggurat.py``) to
the installed numpy, by its compiled module's bytes and by its draws from
crafted generator states, a numpy model of the kernels' resolution
(which positions start an attempt, which attempts yield, each value's index
by the scan of the words that yield nothing) to ``rng.normal`` bit for bit,
and ``nmf.fit``'s host path.  Tests marked ``cuda`` hold the kernels to
``nmf._init`` on the card; they skip elsewhere.  The module imports nothing
of JAX, so ``pytest -m cuda`` runs it on a GPU machine.
"""

import math
import os
import sys
from typing import NamedTuple

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from repro_torch.analytics import nmf  # noqa: E402
from repro_torch.core import Session, telemetry  # noqa: E402
from repro_torch.data import nmf_dataset  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.nmf_init import ops, ziggurat  # noqa: E402

CPU = torch.device("cpu")
TO01 = 1.0 / 9007199254740992.0
# the normal tail's start and its reciprocal, numpy's ziggurat constants
# (distributions/ziggurat_constants.h); the kernels hold them as literals
NOR_R = 3.6541528853610087963519472518
NOR_INV_R = 0.27366123732975827203338247596
RABS_MASK = (1 << 52) - 1
MULT_INV = pow(ops.MULT, -1, 1 << 128)
# the nmf cell's factors: Netflix's 480,189 users x 17,770 movies at rank 64
CELL = (480_189, 17_770, 64)
# twenty seeds, small and past 32 bits, as the benchmark draws them
SEEDS = [0, 1, 2, 3, 7, 11, 42, 99, 123, 1000, 4242, 65_537, 123_457, 999_983, 2**31 - 1,
         2**31 + 17, 2**32 + 5, 2**40 + 3, 3_141_592_653, 2_718_281_828]
# (n, m, k): P (n, k) and Q (k, m), n·k and k·m odd sizes, k = 1, one value,
# and totals across a tile (4,096 positions) boundary
SHAPES = [(7, 11, 3), (1, 1, 1), (37, 19, 1), (1000, 333, 5), (611, 97, 7), (1, 4095, 1),
          (4096, 1, 1), (523, 251, 16)]


class Tables(NamedTuple):
    """numpy's float64 ziggurat: ``ki`` (256,) uint64 fast-path bounds,
    ``wi`` and ``fi`` (256,) float64."""

    ki: np.ndarray
    wi: np.ndarray
    fi: np.ndarray


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs files in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tab():
    return Tables(ops.KI, ops.WI, ops.FI)


@pytest.fixture
def cuda():
    """The card, decided when the test runs (never at import or collection)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _bits(a) -> np.ndarray:
    a = np.ascontiguousarray(a)
    return a.view(np.uint32 if a.dtype == np.float32 else np.uint64)


def _numpy_abs(sizes, state, inc):
    """abs(normal(size)) as float32 for each size in turn, from a PCG64
    standing at (state, inc): what ``_init`` does for a seed's state."""
    gen = generator(state, inc)
    return [np.abs(gen.normal(size=s)).astype(np.float32) for s in sizes]


# -- PCG64 at chosen states --------------------------------------------------------


def xsl_rr(state: int) -> int:
    """PCG64's output word of a 128-bit state."""
    hi, lo = state >> 64, state & ops.MASK64
    rot = hi >> 58
    x = hi ^ lo
    return ((x >> rot) | (x << (-rot & 63))) & ops.MASK64


def crafted(words):
    """``(state, inc)`` whose next one or two words are ``words``: the state
    after the first step is the first word (its high half zero, so the
    rotation is none), and ``inc`` carries it to the second.  Two words need
    opposite parities (``inc`` is odd)."""
    w0 = int(words[0])
    inc = 1 if len(words) == 1 else (int(words[1]) - w0 * ops.MULT) & ops.MASK128
    if len(words) > 2 or not inc & 1:
        raise ValueError("crafted() sets one word, or two of opposite parities")
    return (w0 - inc) * MULT_INV & ops.MASK128, inc


def generator(state, inc, gen=None):
    """A numpy Generator whose PCG64 stands at ``(state, inc)``: ``gen``,
    moved there, or a new one."""
    gen = gen or np.random.Generator(np.random.PCG64(0))
    gen.bit_generator.state = {"bit_generator": "PCG64",
                               "state": {"state": state, "inc": inc},
                               "has_uint32": 0, "uinteger": 0}
    return gen


def words_taken(gen, state, inc, limit=64):
    """How many words ``gen`` took since it stood at ``state``."""
    now = int(gen.bit_generator.state["state"]["state"])
    m, p = ops.jump(1, inc)
    for n in range(limit + 1):
        if state == now:
            return n
        state = (m * state + p) & ops.MASK128
    return limit + 1


def word(idx, rabs, sign=0):
    return idx | sign << 8 | rabs << 9


def u_word(u, parity):
    """A word whose ``next_double`` is ``u * 2**-53``, of the given parity."""
    return u << 11 | parity


# -- numpy's tables, read from its draws -------------------------------------------


def read_wi() -> np.ndarray:
    # rabs 1 returns wi[idx]: on the fast path, or, where ki[idx] is 0, on
    # the wedge's accept, which a uniform of 0 forces (fi[idx] < 1)
    wi = np.empty(256)
    for idx in range(256):
        w0 = word(idx, 1)
        wi[idx] = generator(*crafted([w0, u_word(0, 1 - (w0 & 1))])).standard_normal()
    return wi


def read_ki() -> np.ndarray:
    # the smallest rabs whose attempt takes a second word
    ki = np.empty(256, dtype=np.uint64)
    gen = generator(*crafted([0]))
    for idx in range(256):
        lo, hi = 0, 1 << 52
        while lo < hi:
            mid = (lo + hi) // 2
            state, inc = crafted([word(idx, mid)])
            generator(state, inc, gen).standard_normal()
            if words_taken(gen, state, inc) == 1:
                lo = mid + 1
            else:
                hi = mid
        ki[idx] = lo
    return ki


def check_fi(ki, wi, fi) -> None:
    """Each wedge test at the uniform where it turns from accept to reject,
    both sides, against numpy's own decision on crafted words."""
    for idx in range(1, 256):
        rabs = (int(ki[idx]) + (1 << 52)) // 2     # midway through the wedge
        if rabs >= 1 << 52:
            continue
        x = rabs * float(wi[idx])
        e = math.exp(-0.5 * x * x)
        d, f = float(fi[idx - 1]) - float(fi[idx]), float(fi[idx])

        def accepts(u):
            return d * (u * TO01) + f < e
        lo, hi = 0, 1 << 53          # the first u that rejects
        while lo < hi:
            mid = (lo + hi) // 2
            if accepts(mid):
                lo = mid + 1
            else:
                hi = mid
        w0 = word(idx, rabs)
        for u in (lo - 1, lo):
            if not 0 <= u < 1 << 53:
                continue
            state, inc = crafted([w0, u_word(u, 1 - (w0 & 1))])
            gen = generator(state, inc)
            got = gen.standard_normal()
            took = words_taken(gen, state, inc)
            assert (got == x and took == 2) == accepts(u), \
                f"fi[{idx}] does not give numpy's wedge test at u = {u}"


def sequential_normals(words: np.ndarray, n: int, tab: Tables) -> np.ndarray:
    """numpy's ``random_standard_normal`` over ``words``, one attempt after
    another: ``n`` float64 values (signed)."""
    out, p = [], 0
    ki, wi, fi = tab.ki, tab.wi, tab.fi

    def nd(w):
        return float(int(w) >> 11) * TO01
    while len(out) < n:
        w = int(words[p])
        p += 1
        idx, r = w & 0xFF, w >> 8
        rabs = (r >> 1) & RABS_MASK
        x = rabs * float(wi[idx])
        if r & 1:
            x = -x
        if rabs < int(ki[idx]):
            out.append(x)
        elif idx == 0:
            while True:
                xx = -NOR_INV_R * math.log1p(-nd(words[p]))
                yy = -math.log1p(-nd(words[p + 1]))
                p += 2
                if yy + yy > xx * xx:
                    out.append(-(NOR_R + xx) if (rabs >> 8) & 1 else NOR_R + xx)
                    break
        elif (float(fi[idx - 1]) - float(fi[idx])) * nd(words[p]) + float(fi[idx]) < \
                math.exp(-0.5 * x * x):
            p += 1
            out.append(x)
        else:
            p += 1
    return np.array(out)


# -- the kernels' algorithm in numpy --------------------------------------------


def slow_attempt(words, p, tab):
    """What the attempt the slow word ``words[p]`` starts would do: the
    words it takes, whether it yields, |value| as float32."""
    w = int(words[p])
    idx, rabs = w & 0xFF, (w >> 9) & RABS_MASK
    x = rabs * float(tab.wi[idx])
    if idx:
        u = (int(words[p + 1]) >> 11) * TO01
        y = (float(tab.fi[idx - 1]) - float(tab.fi[idx])) * u + float(tab.fi[idx])
        return 2, y < math.exp(-0.5 * x * x), np.float32(x)
    tries = 1
    while True:
        u1 = (int(words[p + 2 * tries - 1]) >> 11) * TO01
        u2 = (int(words[p + 2 * tries]) >> 11) * TO01
        xx = -NOR_INV_R * math.log1p(-u1)
        yy = -math.log1p(-u2)
        if yy + yy > xx * xx:
            return 1 + 2 * tries, True, np.float32(NOR_R + xx)
        tries += 1


def model(sizes, state, inc, tab, n_words=None):
    """The kernels' resolution over the stream at (state, inc): float32
    arrays of ``sizes`` (unwritten entries NaN) and the done flag.

    count/slow: each slow position with its attempt's reach, yield and
    value, in order.  resolve: heads (no earlier slow position reaches over
    them), each head's cluster walked for its starts; the words that yield
    nothing a start, scanned (dex, with the total at the end).  write: a
    fast position yields unless the last start before it reaches over it; a
    slow one yields if it is a start that yields; its index is its position
    less the words before it that yield nothing."""
    n_values = sum(sizes)
    n_words = ops.word_budget(n_values) if n_words is None else n_words
    words = generator(state, inc).bit_generator.random_raw(n_words + 2 * 64 + 1)
    w = words[:n_words]
    idx = (w & np.uint64(0xFF)).astype(np.int64)
    rabs = (w >> np.uint64(9)) & np.uint64(RABS_MASK)
    pos = np.flatnonzero(rabs >= tab.ki[idx])
    n = pos.size
    att = [slow_attempt(words, int(p), tab) for p in pos]
    nxt = pos + np.array([a[0] for a in att], dtype=np.int64)
    yld = np.array([a[1] for a in att], dtype=bool)
    vals = np.array([a[2] for a in att], dtype=np.float32)
    reach = int((nxt - pos).max(initial=1))

    def is_head(i):
        j = i - 1
        while j >= 0 and pos[j] > pos[i] - reach:
            if nxt[j] > pos[i]:
                return False
            j -= 1
        return True
    start = np.zeros(n, dtype=bool)
    drop = np.zeros(n + 1, dtype=np.int64)
    for i in range(n):
        if not is_head(i):
            continue
        cur = i
        while True:
            start[cur] = True
            drop[cur] = nxt[cur] - pos[cur] - yld[cur]
            j = cur + 1
            while j < n and pos[j] < nxt[cur]:
                j += 1
            if j >= n or is_head(j):
                break
            cur = j
    dex = np.concatenate([[0], np.cumsum(drop[:n])])      # exclusive, total at [n]
    out = np.full(n_values, np.nan, dtype=np.float32)
    written = np.zeros(n_values, dtype=np.int64)

    def put(index, v):
        keep = index < n_values
        np.add.at(written, index[keep], 1)
        out[index[keep]] = v[keep]
    keep = start & yld
    put(pos[keep] - dex[:n][keep], vals[keep])
    fast = np.ones(n_words, dtype=bool)
    fast[pos] = False
    p = np.flatnonzero(fast)
    j = np.searchsorted(pos, p)                          # first slow >= p
    last = np.maximum.accumulate(np.where(start, np.arange(n), -1)) if n else np.zeros(0, int)
    k = np.where(j > 0, last[np.maximum(j - 1, 0)] if n else -1, -1)
    free = (k < 0) | (nxt[np.maximum(k, 0)] <= p) if n else np.ones(p.size, bool)
    index = np.where(k >= 0, p - dex[np.maximum(k, 0) + 1], p) if n else p
    v = (rabs[p].astype(np.float64) * tab.wi[idx[p]]).astype(np.float32)
    put(index[free], v[free])
    assert written.max(initial=0) <= 1          # no index written twice
    done = bool(written[-1]) if n_values else True
    if done:
        assert written.all()                    # the last index implies all before it
    return np.split(out, np.cumsum(sizes)[:-1]), done


# -- the tables --------------------------------------------------------------------


def test_tables_are_numpys_by_crafted_draws(tab):
    """Each wi[idx] is the value of the word (idx, rabs 1); each ki[idx] the
    first rabs whose attempt takes a second word; each value of a fast word
    at the bound's edge is rabs * wi[idx] in one word."""
    gen = generator(*crafted([0]))
    for idx in range(256):
        ki = int(tab.ki[idx])
        if ki > 0:
            state, inc = crafted([word(idx, ki - 1, sign=1)])
            got = generator(state, inc, gen).standard_normal()
            assert got == -((ki - 1) * tab.wi[idx]) and words_taken(gen, state, inc) == 1
        if ki < 1 << 52:
            state, inc = crafted([word(idx, ki)])
            generator(state, inc, gen).standard_normal()
            assert words_taken(gen, state, inc) > 1
        w0 = word(idx, 1)
        assert generator(*crafted([w0, u_word(0, 1 - (w0 & 1))]),
                         gen).standard_normal() == tab.wi[idx]
    assert tab.fi[0] == 1.0 and np.all(np.diff(tab.fi) < 0)
    assert tab.wi[255] * 2.0**52 == NOR_R


def test_committed_tables_are_read_from_numpys_draws(tab):
    """wi and ki read out of the installed numpy by crafted draws equal the
    committed tables bit for bit; fi gives numpy's wedge decisions; the
    tail's constants give numpy's tail values."""
    np.testing.assert_array_equal(_bits(read_wi()), _bits(tab.wi))
    np.testing.assert_array_equal(read_ki(), tab.ki)
    check_fi(tab.ki, tab.wi, tab.fi)
    w0 = word(0, (1 << 52) - 1)             # a slow attempt in the base strip
    for u in (1, 1 << 40, 1 << 52, (1 << 53) - 1):
        state, inc = crafted([w0, u_word(u, 1 - (w0 & 1))])
        got = generator(state, inc).standard_normal(size=4)
        want = sequential_normals(generator(state, inc).bit_generator.random_raw(64), 4, tab)
        np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("name", ["KI", "WI", "FI"])
def test_committed_tables_are_in_numpys_module(name):
    """Each table's 2,048 bytes stand verbatim in the installed numpy's
    compiled ``_generator`` module, where its ``normal`` reads them."""
    with open(np.random._generator.__file__, "rb") as f:
        data = f.read()
    assert np.array(getattr(ziggurat, name), dtype=np.uint64).tobytes() in data


@pytest.mark.parametrize("idx", [1, 2, 128, 254, 255])
def test_fi_check_refuses_a_table_a_few_ulps_off(tab, idx):
    """numpy's wedge test at its turning uniform, midway through each
    layer's wedge, pins fi to within an ulp or two: 16 ulps more at any
    layer are refused."""
    fi = tab.fi.copy()
    for _ in range(16):
        fi[idx] = np.nextafter(fi[idx], 2.0)
    check_fi(tab.ki, tab.wi, tab.fi)
    with pytest.raises(AssertionError, match=f"fi\\[{idx}\\]"):
        check_fi(tab.ki, tab.wi, fi)


@pytest.mark.parametrize("seed", [0, 11, 2**33 + 1])
def test_sequential_ziggurat_is_numpys(tab, seed):
    """numpy's random_standard_normal over the raw words, attempt by
    attempt, is rng.normal bit for bit (200,000 values: ~3,000 slow
    attempts, ~50 tails)."""
    words = np.random.PCG64(seed).random_raw(210_000)
    got = sequential_normals(words, 200_000, tab)
    want = np.random.default_rng(seed).normal(size=200_000)
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_jump_is_the_step_repeated():
    state, inc = ops.seeded(5)
    s = state
    for delta in range(1, 300):
        s = (s * ops.MULT + inc) & ops.MASK128
        m, p = ops.jump(delta, inc)
        assert (m * state + p) & ops.MASK128 == s
    words = np.random.PCG64(5).random_raw(300)
    m, p = ops.jump(257, inc)
    assert xsl_rr((m * state + p) & ops.MASK128) == int(words[256])


def test_crafted_states_give_their_words():
    for words in ([5], [12345, 2**63 + 2], [2**64 - 1, 6]):
        state, inc = crafted(words)
        got = generator(state, inc).bit_generator.random_raw(len(words))
        assert [int(x) for x in got] == words
    with pytest.raises(ValueError):
        crafted([2, 4])


# -- the resolution --------------------------------------------------------------


@pytest.mark.parametrize("n,m,k", SHAPES)
def test_model_is_rng_normal_over_twenty_seeds(tab, n, m, k):
    """The resolution's P0 and Q0 equal ``_init``'s bit for bit, every
    index written once, done set."""
    sizes = [n * k, k * m]
    for seed in SEEDS:
        (p, q), done = model(sizes, *ops.seeded(seed), tab)
        want_p, want_q = nmf._init(n, m, k, seed)
        assert done
        np.testing.assert_array_equal(_bits(p), _bits(want_p.ravel()), err_msg=f"seed {seed}")
        np.testing.assert_array_equal(_bits(q), _bits(want_q.ravel()), err_msg=f"seed {seed}")


def test_model_over_a_long_stream(tab):
    """200,000 + 60,000 values: thousands of slow attempts, clusters, tails."""
    sizes = [200_000, 60_000]
    for seed in (3, 2**35 + 9):
        (p, q), done = model(sizes, *ops.seeded(seed), tab)
        want = _numpy_abs(sizes, *ops.seeded(seed))
        assert done
        np.testing.assert_array_equal(_bits(p), _bits(want[0]))
        np.testing.assert_array_equal(_bits(q), _bits(want[1]))


def test_model_flags_a_short_stream(tab):
    """With as many words as values some value is left unwritten, and the
    done flag says so."""
    sizes = [40_000, 1]
    (_, q), done = model(sizes, *ops.seeded(1), tab, n_words=sum(sizes))
    assert not done and np.isnan(q).all()


def _crafted_case(tab, case):
    """(state, inc) whose first word starts the slow attempt ``case``."""
    if case == "tail":
        w0 = word(0, (1 << 52) - 1)
        return crafted([w0, u_word(1 << 52, 1 - (w0 & 1))])
    idx = 200
    rabs = (1 << 52) - 1
    x = rabs * float(tab.wi[idx])
    e = math.exp(-0.5 * x * x)
    d, f = float(tab.fi[idx - 1]) - float(tab.fi[idx]), float(tab.fi[idx])
    u = 0 if case == "wedge_accept" else (1 << 53) - 1
    assert (d * (u * TO01) + f < e) == (case == "wedge_accept")
    w0 = word(idx, rabs)
    return crafted([w0, u_word(u, 1 - (w0 & 1))])


CRAFTED = ["wedge_accept", "wedge_reject", "tail"]


@pytest.mark.parametrize("case", CRAFTED)
def test_model_follows_crafted_slow_attempts(tab, case):
    """A stream that opens with a wedge accept, a wedge reject or the tail:
    numpy's first value shows the branch taken, and the model follows it."""
    state, inc = _crafted_case(tab, case)
    gen = generator(state, inc)
    first = gen.standard_normal()
    taken = words_taken(gen, state, inc)
    x = ((1 << 52) - 1) * tab.wi[200]
    if case == "wedge_accept":
        assert first == x and taken == 2
    elif case == "wedge_reject":
        assert first != x and taken > 2
    else:
        assert abs(first) > NOR_R and taken >= 3
    sizes = [6, 5]
    got, done = model(sizes, state, inc, tab)
    want = _numpy_abs(sizes, state, inc)
    assert done
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_bits(g), _bits(w))


# -- nmf.fit -----------------------------------------------------------------------


def _counting(monkeypatch, module, name: str) -> list:
    """Replace ``module.name`` by a wrapper that records each call's
    arguments; returns the record."""
    calls, fn = [], getattr(module, name)

    def counted(*args):
        calls.append(args)
        return fn(*args)

    monkeypatch.setattr(module, name, counted)
    return calls


def test_cpu_fit_draws_on_the_host_once_a_job(monkeypatch):
    """A traced CPU job draws with numpy's ``_init`` once and launches no
    kernel; its factors are the untraced job's."""
    r, _, _ = nmf_dataset(60, 20, 3, seed=4)
    calls = _counting(monkeypatch, nmf, "_init")
    build.reset_launches()
    sess = Session(backend="host", n_nodes=2, threads_per_node=2, trace=True, device=CPU)
    try:
        p, q, _ = nmf.fit(r, 3, iters=4, seed=9, session=sess)
        nmf.fit(r, 3, iters=2, seed=10, session=sess)
    finally:
        sess.tracer.disable()
    assert calls == [(60, 20, 3, 9), (60, 20, 3, 10)]
    assert not any(build.launch_counts().values())
    want_p, want_q, _ = nmf.fit(r, 3, iters=4, seed=9, device=CPU)
    np.testing.assert_allclose(p, want_p, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(q, want_q, rtol=1e-5, atol=1e-6)
    assert telemetry.armed_count() == 0


def test_abs_normals_refuses_a_stream_past_int32_positions():
    """The card's positions are int32: a draw past MAX_WORDS words raises,
    before any device is touched, and never falls back to the host."""
    with pytest.raises(ValueError, match="int32 positions"):
        ops.abs_normals(ops.MAX_WORDS, 1, 1, *ops.seeded(0), CPU)
    fits = (ops.MAX_WORDS - 4096) * 16 // 17 - 16
    assert ops.word_budget(fits) <= ops.MAX_WORDS
    with pytest.raises(ValueError, match="runs on the card"):
        ops.abs_normals(fits, 0, 1, *ops.seeded(0), CPU)


def test_abs_normals_refuses_the_cpu():
    with pytest.raises(ValueError):
        ops.abs_normals(2, 2, 2, *ops.seeded(0), CPU)


# -- on the card -----------------------------------------------------------------


def _card(n, m, k, state, inc, device):
    p, q, done = ops.abs_normals(n, m, k, state, inc, device)
    torch.cuda.synchronize()
    return p.cpu().numpy(), q.cpu().numpy(), int(done)


@pytest.mark.cuda
@pytest.mark.parametrize("n,m,k", SHAPES + [CELL])
def test_card_draw_is_init_over_twenty_seeds(cuda, n, m, k):
    """P0 and Q0 drawn on the card equal ``_init``'s bit for bit."""
    for seed in SEEDS:
        p, q, done = _card(n, m, k, *ops.seeded(seed), cuda)
        want_p, want_q = nmf._init(n, m, k, seed)
        assert done == 1
        np.testing.assert_array_equal(_bits(p), _bits(want_p), err_msg=f"seed {seed}")
        np.testing.assert_array_equal(_bits(q), _bits(want_q), err_msg=f"seed {seed}")


@pytest.mark.cuda
@pytest.mark.parametrize("case", CRAFTED)
def test_card_follows_crafted_slow_attempts(cuda, tab, case):
    state, inc = _crafted_case(tab, case)
    p, q, done = _card(3, 5, 2, state, inc, cuda)
    want = _numpy_abs([(3, 2), (2, 5)], state, inc)
    assert done == 1
    np.testing.assert_array_equal(_bits(p), _bits(want[0]))
    np.testing.assert_array_equal(_bits(q), _bits(want[1]))


@pytest.mark.cuda
def test_card_flags_a_short_stream(cuda, monkeypatch):
    """Too few words, or too little room for the slow list: done stays 0."""
    monkeypatch.setattr(ops, "word_budget", lambda n: n)
    assert _card(40_000, 1, 1, *ops.seeded(1), cuda)[2] == 0
    monkeypatch.undo()
    monkeypatch.setattr(ops, "slow_capacity", lambda n: 8)
    assert _card(40_000, 1, 1, *ops.seeded(1), cuda)[2] == 0


@pytest.mark.cuda
def test_card_scratch_is_under_64_mb(cuda):
    """At the cell's shape the draw holds its outputs and under 64 MB more."""
    n, m, k = CELL
    ops.abs_normals(4, 4, 4, *ops.seeded(0), cuda)       # tables, library
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    p, q, _ = ops.abs_normals(n, m, k, *ops.seeded(1), cuda)
    torch.cuda.synchronize()
    outputs = 4 * (n * k + k * m)
    assert torch.cuda.max_memory_allocated() - held - outputs < 64 << 20


@pytest.mark.cuda
def test_traced_card_job_draws_on_the_card(cuda, monkeypatch):
    """A traced card job never draws with numpy's ``_init`` and launches
    the draw's six kernels; its factors are the CPU job's."""
    r, _, _ = nmf_dataset(60, 20, 3, seed=4)
    calls = _counting(monkeypatch, nmf, "_init")
    build.reset_launches()
    sess = Session(backend="host", n_nodes=2, threads_per_node=2, trace=True, device=cuda)
    try:
        p, q, _ = nmf.fit(r, 3, iters=4, seed=9, session=sess)
    finally:
        sess.tracer.disable()
    assert not calls
    assert build.launch_counts()["nmf_init"] == ops.LAUNCHES_A_DRAW == 6
    want_p, want_q, _ = nmf.fit(r, 3, iters=4, seed=9, device=CPU)
    np.testing.assert_allclose(p, want_p, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(q, want_q, rtol=1e-4, atol=1e-6)
    assert telemetry.armed_count() == 0
