"""The port's native host tier against the JAX package's binding of the
same C++ source: every entry point bit-equal on the same inputs, and each
call site of the port taking the native tier at the JAX package's
thresholds (or under a lowered threshold) with the JAX package's arrays."""
import filecmp
import pathlib

import numpy as np
import pytest

from pytorch_geometric_signed_directed_tpu import native as jx_native
from pytorch_geometric_signed_directed_tpu.data import load_real as jx_load
from pytorch_geometric_signed_directed_tpu.ops import coalesce as jx_coalesce
from pytorch_geometric_signed_directed_tpu.spectral import (
    magnetic as jx_magnetic)

from pytorch_geometric_signed_directed_tpu_torch import native
from pytorch_geometric_signed_directed_tpu_torch.data import (
    load_real, schema_files)
from pytorch_geometric_signed_directed_tpu_torch.ops import coalesce
from pytorch_geometric_signed_directed_tpu_torch.spectral import magnetic

from test_torch_worker_memory import release_memory  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def jax_binding():
    # the reference: without g++ the JAX binding returns None everywhere
    if not jx_native.available():
        pytest.skip("the JAX package's native binding did not build")


def assert_same(got, want):
    if isinstance(want, dict):
        assert got.keys() == want.keys()
        for k in want:
            assert_same(got[k], want[k])
        return
    if isinstance(want, tuple):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert_same(a, b)
        return
    if isinstance(want, np.ndarray):
        assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.fixture
def native_calls(monkeypatch):
    """Counts the port's loads of the native library, one per call."""
    calls = []
    load = native._load

    def counted():
        calls.append(1)
        return load()

    monkeypatch.setattr(native, "_load", counted)
    return calls


def edges(n, e, seed, loops=0):
    rng = np.random.default_rng(seed)
    row, col = rng.integers(0, n, e), rng.integers(0, n, e)
    row[:loops] = col[:loops]
    return row, col, rng.standard_normal(e)


def test_source_is_a_byte_for_byte_copy():
    assert filecmp.cmp(native.SOURCE, ROOT / "csrc" / "pgsd_native.cpp",
                       shallow=False)


def test_failed_build_raises_with_the_compiler_output(tmp_path,
                                                       monkeypatch):
    bad = tmp_path / "broken.cpp"
    bad.write_text("int main( {\n")
    monkeypatch.setattr(native, "SOURCE", str(bad))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.stable_argsort(np.arange(1 << 20, dtype=np.int64) << 33)


def test_parse_signed_csv(tmp_path):
    path = schema_files.write_signed_csv(str(tmp_path), num_nodes=300,
                                         num_pos=2000, num_neg=400)
    assert_same(native.parse_signed_csv(path),
                jx_native.parse_signed_csv(path))
    with pytest.raises(FileNotFoundError):
        native.parse_signed_csv(str(tmp_path / "missing.csv"))


@pytest.mark.parametrize("high", [1 << 40, 7 << 33, 1 << 20])
def test_stable_argsort(high):
    keys = np.random.default_rng(3).integers(0, high, (1 << 20) + 5)
    if high == 7 << 33:   # runs of equal keys: stability decides the order
        keys = keys // (1 << 33) * (1 << 33)
    got = native.stable_argsort(keys)
    assert_same(got, jx_native.stable_argsort(keys))
    assert_same(got, np.argsort(keys, kind="stable"))


@pytest.mark.parametrize("nvals", [0, 1, 3])
def test_coalesce_multi(nvals):
    rng = np.random.default_rng(5)
    keys = rng.integers(0, 40_000, 300_000)
    vals = [rng.standard_normal(len(keys)).astype(dt)
            for dt in (np.float64, np.float32, np.float64)[:nvals]]
    assert_same(native.coalesce_multi(keys, *vals),
                jx_native.coalesce_multi(keys, *vals))


def test_coalesce():
    row, col, w = edges(50, 5000, seed=0)
    assert_same(native.coalesce(row, col, w.astype(np.float32), 50),
                jx_native.coalesce(row, col, w.astype(np.float32), 50))


@pytest.mark.parametrize("grouped,window,chunk",
                         [(False, 128, 1024), (True, 512, 2048)])
def test_plan_layout(grouped, window, chunk):
    rng = np.random.default_rng(7)
    row = rng.integers(0, 2000, 30_000)
    grp = (rng.random(len(row)) < 0.3).astype(np.int8) if grouped else None
    assert_same(native.plan_layout(row, 2000, window, chunk, grp),
                jx_native.plan_layout(row, 2000, window, chunk, grp))


@pytest.mark.parametrize("grouped", [False, True])
def test_window_hist(grouped):
    rng = np.random.default_rng(9)
    row = rng.integers(0, 5000, 40_000)
    grp = (rng.random(len(row)) < 0.5).astype(np.int8) if grouped else None
    nbins = (5000 >> 7) * 2 + 2
    assert_same(native.window_hist(row, grp, nbins),
                jx_native.window_hist(row, grp, nbins))


@pytest.mark.parametrize("dtype", [np.int32, np.float32, np.int64,
                                   np.float64])
def test_permute_gather(dtype):
    rng = np.random.default_rng(8)
    perm = np.full(6144, -1, np.int64)
    perm[rng.choice(6144, 5000, replace=False)] = rng.permutation(5000)
    src = (rng.standard_normal(5000) * 100).astype(dtype)
    assert_same(native.permute_gather(perm, src),
                jx_native.permute_gather(perm, src))


def test_permute_gather_rejects_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="4- or 8-byte"):
        native.permute_gather(np.zeros(3, np.int64), np.zeros(3, np.int16))


def test_symmetrize():
    row, col, w = edges(400, 6000, seed=11, loops=50)
    assert_same(native.symmetrize(row, col, w, 400),
                jx_native.symmetrize(row, col, w, 400))


@pytest.mark.parametrize("deg_mode", [0, 1, 2])
def test_magnetic_sym_lap(deg_mode):
    row, col, w = edges(300, 5000, seed=12, loops=20)
    assert_same(native.magnetic_sym_lap(row, col, w, 300, 0.2, deg_mode),
                jx_native.magnetic_sym_lap(row, col, w, 300, 0.2, deg_mode))


# ---------------------------------------------------------------------------
# The call sites


def test_coalesce_edges_takes_the_fused_branch(monkeypatch, native_calls):
    """As the JAX package's own test of this branch: the threshold lowered
    on both modules, so both take the native pass."""
    row, col, w1 = edges(300, 50_000, seed=8)
    w2 = w1.astype(np.float32)[::-1].copy()
    w3 = np.random.default_rng(1).integers(0, 5, len(row))
    monkeypatch.setattr(coalesce, "FUSED_COALESCE_MIN", 1)
    monkeypatch.setattr(jx_coalesce, "FUSED_COALESCE_MIN", 1)
    got = coalesce.coalesce_edges(row, col, w1, w2, w3, num_cols=300)
    assert native_calls
    assert_same(got, jx_coalesce.coalesce_edges(row, col, w1, w2, w3,
                                                num_cols=300))


def test_coalesce_edges_radix_sorts_wide_keys(monkeypatch, native_calls):
    """Keys wider than 32 bits from ARGSORT_MIN on take the radix sort;
    the JAX package's numpy sort of them below its 2^20 gives the same
    order."""
    row, col, w = edges(3000, 40_000, seed=4)
    col = col << 22                      # num_cols 2^34: wide keys
    monkeypatch.setattr(native, "ARGSORT_MIN", 1)
    got = coalesce.coalesce_edges(row, col, w, num_cols=1 << 34)
    assert native_calls
    assert_same(got, jx_coalesce.coalesce_edges(row, col, w,
                                                num_cols=1 << 34))


def test_laplacians_at_the_native_threshold(native_calls):
    """At 2^20 input edges both packages take their native branches of the
    magnetic and signed magnetic Laplacians and of the symmetrization."""
    row, col, w = edges(4000, 1 << 20, seed=13, loops=100)
    ei = np.stack([row, col])
    for fn, kw in (("magnetic_laplacian", {}),
                   ("magnetic_laplacian", {"normalization": None}),
                   ("magnetic_signed_laplacian", {}),
                   ("magnetic_signed_laplacian",
                    {"absolute_degree": False})):
        ww = w if fn == "magnetic_signed_laplacian" else np.abs(w)
        calls = len(native_calls)
        got = getattr(magnetic, fn)(ei, ww, num_nodes=4000, q=0.2, **kw)
        assert len(native_calls) > calls, (fn, kw)
        assert_same(got, getattr(jx_magnetic, fn)(ei, ww, num_nodes=4000,
                                                  q=0.2, **kw))


def test_laplacians_take_the_native_branch_below_a_lowered_threshold(
        monkeypatch, native_calls):
    """Under a lowered threshold the port's small build is the JAX
    binding's: the sym-normalized Laplacian is ``magnetic_sym_lap``, the
    unnormalized one starts from ``symmetrize``."""
    row, col, w = edges(200, 3000, seed=14, loops=10)
    ei = np.stack([row, col])
    monkeypatch.setattr(magnetic, "NATIVE_MIN_EDGES", 1)
    orow, ocol, w_re, w_im = jx_native.magnetic_sym_lap(row, col, w, 200,
                                                        0.25, 1)
    assert_same(magnetic.magnetic_signed_laplacian(ei, w, num_nodes=200),
                (np.stack([orow, ocol]), w_re, w_im))
    srow, scol, sym, theta, _ = jx_native.symmetrize(row, col, np.abs(w),
                                                     200)
    got_ei, got_re, got_im = magnetic.magnetic_laplacian(
        ei, np.abs(w), normalization=None, num_nodes=200)
    m = len(srow)
    assert_same(got_ei[:, :m], np.stack([srow, scol]))
    ang = 2 * np.pi * 0.25 * theta
    assert_same(got_re[:m], -(sym / 2.0) * np.cos(ang))
    assert_same(got_im[:m], -(sym / 2.0) * np.sin(ang))
    assert native_calls


def test_signed_csv_loader_parses_natively(tmp_path, monkeypatch,
                                           native_calls):
    monkeypatch.setenv("PGSD_TPU_NO_CACHE", "1")
    schema_files.write_signed_csv(str(tmp_path), "slashdot", num_nodes=500,
                                  num_pos=3000, num_neg=700, seed=5)
    got = load_real.SDGNN_real_data("slashdot", str(tmp_path))
    want = jx_load.SDGNN_real_data("slashdot", str(tmp_path))
    assert native_calls
    assert_same(got.edge_index, want.edge_index)
    assert_same(got.edge_weight, want.edge_weight)
