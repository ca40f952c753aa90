"""nmf's two products over R on the card: ``csrc/nmf_products.cu`` (R·Qᵀ and
Pᵀ·R in 3xTF32 on the tensor cores) against float64 products.

CPU tests hold the wrappers' refusals (CPU tensors, other dtypes, rows that
are not contiguous, shapes that disagree), ``_update_p`` and ``_q_partials``
to today's ``torch.matmul`` bits on the CPU, a CPU ``fit`` to no launch, and
a torch model of the kernel's arithmetic (the split, the three TF32
products, chains of twelve products summed from zero and added into two
levels of fp32 sums) to float32's accuracy, twice a float32 FFMA sum's
error, where one TF32 product misses it.  Tests marked ``cuda`` hold the
kernel itself: ragged shapes and views that start at odd
rows, one thread's slice of the nmf cell, two calls bit-equal, and a card
``fit`` on both backends.  Errors are scaled element by element by
(|A|·|B|) and held to twice ``torch.matmul``'s float32 error on the same
inputs (TF32 off), or 2^-20 where that is smaller: at a tiny K the dropped
small·small term (~2^-21 of a product) outweighs float32's rounding.  The
module imports nothing of JAX, so ``pytest -m cuda`` runs it on a GPU
machine.
"""

import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from repro_torch.analytics import nmf  # noqa: E402
from repro_torch.core import Session, SpmdBackend  # noqa: E402
from repro_torch.core.compat import make_mesh  # noqa: E402
from repro_torch.data import nmf_dataset  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.nmf_products import ops  # noqa: E402

CPU = torch.device("cpu")
SIZES = (1, 7, 64, 65, 130)          # n and k
COLS = (1, 9, 17_770)                # m: Netflix's 17,770 movies
# one thread's slice of the nmf cell: Netflix's 480,189 users over 4 threads, rank 64
CELL = (120_047, 17_770, 64)
FLOOR = 2.0 ** -20
# the kernel's sums (csrc/nmf_products.cu kChain, kLevel): chains of 4 k-steps
# of 8 on the tensor cores, added into running sums that are added into a
# second level every 8 stages of 64 (16 chains)
CHAIN, LEVEL = 4, 16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs files in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda():
    """The card, decided when the test runs (never at import or collection)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    assert torch.backends.cuda.matmul.allow_tf32 is False
    return torch.device("cuda")


def scaled_error(got: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> float:
    """max |got - a·b| / (|a|·|b|) over the elements, a·b in float64; an
    element whose scale is 0 must be exactly 0."""
    a64, b64 = a.double(), b.double()
    exact = a64 @ b64
    scale = a64.abs() @ b64.abs()
    err = (got.double() - exact).abs()
    zero = scale == 0
    assert not bool((err[zero] > 0).any())
    return float((err[~zero] / scale[~zero]).max()) if bool((~zero).any()) else 0.0


def within_bound(got: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> tuple:
    """The kernel's scaled error and its bound: twice ``torch.matmul``'s in
    float32 on the same inputs, or FLOOR."""
    lib = scaled_error(a @ b, a, b)
    return scaled_error(got, a, b), max(2 * lib, FLOOR)


# -- the wrappers on the CPU ---------------------------------------------------------


def _operands(fn: str, dtype=torch.float32):
    if fn == "rqt":
        return torch.rand(5, 3, dtype=dtype), torch.rand(4, 3, dtype=dtype)
    return torch.rand(5, 4, dtype=dtype), torch.rand(5, 3, dtype=dtype)


@pytest.mark.parametrize("fn", ["rqt", "ptr"])
def test_wrappers_refuse_cpu_tensors(fn):
    with pytest.raises(ValueError, match="runs on the card"):
        getattr(ops, fn)(*_operands(fn))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float16, torch.bfloat16, torch.int32])
@pytest.mark.parametrize("fn", ["rqt", "ptr"])
def test_wrappers_refuse_other_dtypes(fn, dtype):
    a, b = _operands(fn)
    with pytest.raises(TypeError, match="float32"):
        getattr(ops, fn)(a.to(dtype), b)
    with pytest.raises(TypeError, match="float32"):
        getattr(ops, fn)(a, b.to(dtype))


@pytest.mark.parametrize("fn", ["rqt", "ptr"])
def test_wrappers_refuse_rows_that_are_not_contiguous(fn):
    a, b = _operands(fn)
    for bad in ((a.T.contiguous().T, b), (a, b.T.contiguous().T), (a, b[:, ::2])):
        with pytest.raises(ValueError, match="rows are contiguous"):
            getattr(ops, fn)(*bad)


def test_wrappers_refuse_shapes_that_disagree():
    with pytest.raises(ValueError, match="differ in m"):
        ops.rqt(torch.rand(5, 3), torch.rand(4, 2))
    with pytest.raises(ValueError, match="differ in n"):
        ops.ptr(torch.rand(5, 4), torch.rand(6, 3))
    with pytest.raises(TypeError, match="2-D"):
        ops.rqt(torch.rand(5), torch.rand(4, 5))


def test_cpu_update_and_partials_keep_the_matmul_bits():
    """On the CPU the two steps are today's expressions, bit for bit."""
    g = torch.Generator().manual_seed(5)
    r = torch.rand(37, 23, generator=g)
    p = torch.rand(37, 6, generator=g)
    q = torch.rand(6, 23, generator=g)
    assert torch.equal(nmf._update_p(p, q, r), p * (r @ q.T) / (p @ (q @ q.T) + nmf._EPS))
    numer, gram = nmf._q_partials(p, r)
    assert torch.equal(numer, p.T @ r) and torch.equal(gram, p.T @ p)


@pytest.mark.parametrize("backend", ["host", "spmd"])
def test_cpu_fit_makes_no_launch(backend):
    r, _, _ = nmf_dataset(60, 20, 3, seed=4)
    sess = (Session(backend="host", n_nodes=2, threads_per_node=2, device=CPU)
            if backend == "host" else
            Session(backend=SpmdBackend(mesh=make_mesh((4,), ("data",), device=CPU))))
    build.reset_launches()
    nmf.fit(r, 3, iters=3, seed=9, session=sess)
    assert build.launch_counts()["nmf_products"] == 0


# -- the arithmetic, modelled on the CPU ----------------------------------------------


def _tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32 as mma_tf32.cuh's to_tf32 does it."""
    return ((x.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_read(x: torch.Tensor) -> torch.Tensor:
    """What an mma on .tf32 operands reads of a float32 register: its top 19 bits."""
    return (x.view(torch.int32) & ~0x1FFF).view(torch.float32)


def _round32(x64: torch.Tensor, toward_zero: bool) -> torch.Tensor:
    """float64 sums rounded to float32: to nearest, or toward zero."""
    r = x64.float()
    if toward_zero:
        over = r.double().abs() > x64.abs()
        r = torch.where(over, torch.nextafter(r, torch.zeros_like(r)), r)
    return r


def model(a: torch.Tensor, b: torch.Tensor, terms: int, chain: int = CHAIN,
          level: int = LEVEL, toward_zero: bool = False) -> torch.Tensor:
    """a (M, K) · b (K, N) as the kernel sums it: 8-wide k-steps on TF32
    operands (each product of two TF32 numbers exact), each product's sum
    rounded to float32 (to nearest or toward zero); ``terms`` 3 is 3xTF32
    (small·big, big·small, big·big), 1 a single TF32 product; a chain of
    ``chain`` k-steps summed from zero, then added into the running float32
    sums with a rounded add, and those into a second level every ``level``
    chains."""
    ab, bb = _tf32_rna(a), _tf32_rna(b)
    parts = [(_tf32_read(a - ab), bb), (ab, _tf32_read(b - bb)), (ab, bb)] if terms == 3 else [
        (ab, bb)]
    hi = torch.zeros(a.shape[0], b.shape[1])
    lo, blk = torch.zeros_like(hi), torch.zeros_like(hi)
    chains = 0
    for step, k0 in enumerate(range(0, a.shape[1], 8)):
        for x, y in parts:
            blk = _round32(blk.double() + x[:, k0:k0 + 8].double() @ y[k0:k0 + 8].double(),
                           toward_zero)
        if (step + 1) % chain == 0 or k0 + 8 >= a.shape[1]:
            lo, blk, chains = lo + blk, torch.zeros_like(hi), chains + 1
            if chains == level:
                hi, lo, chains = hi + lo, torch.zeros_like(hi), 0
    return hi + lo


def sequential(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (M, K) · b (K, N) as cuBLAS's float32 FFMA kernels sum each output:
    one fused multiply-add a k, in K order."""
    acc = torch.zeros(a.shape[0], b.shape[1])
    a64, b64 = a.double(), b.double()
    for k in range(a.shape[1]):
        acc = (acc.double() + a64[:, k:k + 1] * b64[k:k + 1]).float()
    return acc


def _model_inputs(k_len: int):
    g = torch.Generator().manual_seed(k_len)
    a = torch.randn(16, k_len, generator=g).abs()
    b = torch.randn(k_len, 8, generator=g).abs()
    return a, b, max(2 * scaled_error(sequential(a, b), a, b), FLOOR)


@pytest.mark.parametrize("k_len", [8, 1000, 17_770])
def test_model_of_the_scheme_is_float32_accurate(k_len):
    """3xTF32 with the kernel's chains and levels stays within twice a
    float32 FFMA sum's error, whether each product's sum rounds to nearest
    or truncates."""
    a, b, bound = _model_inputs(k_len)
    for toward_zero in (False, True):
        err = scaled_error(model(a, b, 3, toward_zero=toward_zero), a, b)
        assert err <= bound, (toward_zero, err, bound)


@pytest.mark.parametrize("k_len", [8, 1000])
def test_model_of_one_tf32_product_misses(k_len):
    a, b, bound = _model_inputs(k_len)
    assert scaled_error(model(a, b, 1), a, b) > 4 * bound


def test_model_chains_that_run_the_whole_k_drift_when_sums_truncate():
    """Why the kernel adds short chains into rounded float32 sums: a chain of
    every k-step, truncating, drifts past the bound over nmf's 17,770
    columns of non-negative terms; the kernel's chains do not."""
    a, b, bound = _model_inputs(17_770)
    assert scaled_error(model(a, b, 3, chain=17_770, toward_zero=True), a, b) > 4 * bound
    assert scaled_error(model(a, b, 3, toward_zero=True), a, b) <= bound


# -- on the card ------------------------------------------------------------------


def _slices(n, m, k, device, seed):
    """R (n, m), P (n, k) as views starting at row 3 of larger matrices, Q
    (k, m) from row 1: non-negative, as nmf's are."""
    g = torch.Generator(device=device).manual_seed(seed)
    r = torch.rand(n + 3, m, generator=g, device=device)[3:]
    p = torch.rand(n + 3, k, generator=g, device=device)[3:]
    q = torch.rand(k + 1, m, generator=g, device=device)[1:]
    return r, p, q


@pytest.mark.cuda
@pytest.mark.parametrize("m", COLS)
@pytest.mark.parametrize("k", SIZES)
@pytest.mark.parametrize("n", SIZES)
def test_products_at_ragged_shapes(cuda, n, m, k):
    r, p, q = _slices(n, m, k, cuda, seed=n * 1_000_003 + m * 1009 + k)
    for name, got, a, b in (("rqt", ops.rqt(r, q), r, q.T), ("ptr", ops.ptr(p, r), p.T, r)):
        assert got.shape == (a.shape[0], b.shape[1])
        err, bound = within_bound(got, a, b)
        assert err <= bound, f"{name} at n {n}, m {m}, k {k}: {err:.3e} > {bound:.3e}"


@pytest.mark.cuda
def test_products_at_the_cells_slice(cuda):
    """Both products at one thread's slice of the nmf cell, R from row 3 of
    a larger matrix (its pitch 71,080 B, 8 mod 16); twice each, bit-equal."""
    n, m, k = CELL
    r, p, q = _slices(n, m, k, cuda, seed=2**31 + 11)
    for name, fn, a, b in (("rqt", lambda: ops.rqt(r, q), r, q.T),
                           ("ptr", lambda: ops.ptr(p, r), p.T, r)):
        got = fn()
        assert torch.equal(got, fn()), name
        err, bound = within_bound(got, a, b)
        assert err <= bound, f"{name} at the cell's slice: {err:.3e} > {bound:.3e}"
        del got


@pytest.mark.cuda
@pytest.mark.parametrize("n,m,k", [(20_000, 1000, 64), (4099, 17_770, 7), (70_001, 300, 130)])
def test_two_calls_give_the_same_bits(cuda, n, m, k):
    """P^T.R sums its row splits in a fixed order; R.Q^T has no split."""
    r, p, q = _slices(n, m, k, cuda, seed=n + m + k)
    assert torch.equal(ops.ptr(p, r), ops.ptr(p, r))
    assert torch.equal(ops.rqt(r, q), ops.rqt(r, q))


@pytest.mark.cuda
def test_empty_products_launch_nothing(cuda):
    build.reset_launches()
    assert torch.equal(ops.rqt(torch.rand(0, 5, device=cuda), torch.rand(3, 5, device=cuda)),
                       torch.zeros(0, 3, device=cuda))
    assert torch.equal(ops.ptr(torch.rand(0, 3, device=cuda), torch.rand(0, 5, device=cuda)),
                       torch.zeros(3, 5, device=cuda))
    assert build.launch_counts()["nmf_products"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["host", "spmd"])
def test_card_fit_launches_both_products_a_thread_and_round(cuda, backend):
    """A card job launches 2 x threads x iters products and agrees with the
    CPU's single-thread oracle."""
    r, _, _ = nmf_dataset(600, 40, 3, seed=4)
    sess = (Session(backend="host", n_nodes=2, threads_per_node=2, device=cuda)
            if backend == "host" else
            Session(backend=SpmdBackend(mesh=make_mesh((4,), ("data",), device=cuda))))
    build.reset_launches()
    p, q, _ = nmf.fit(r, 3, iters=5, seed=9, session=sess)
    assert build.launch_counts()["nmf_products"] == 2 * 4 * 5
    want_p, want_q = nmf.fit_reference(r, 3, 5, 9, device=CPU)
    np.testing.assert_allclose(p, want_p, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(q, want_q, rtol=1e-4, atol=1e-6)
