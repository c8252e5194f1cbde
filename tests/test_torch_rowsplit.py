"""The plans that cut long rows for the CSR kernels (K1/K2) and block rows
for the BSR kernel (K5), and the kernels' pass structure emulated in plain
PyTorch on them.

The kernels themselves run only on the card (tests/test_torch_cuda.py);
here the plans (``scatter_csr.plan_row_split``, ``bsr_spmm.plan_block_
split``) are checked edge by edge, and a float64 emulation of what the
kernels do with them (sum each short row and each piece, then add a cut
row's pieces in piece order to its prior value) is held against the plain
versions and against the JAX package's Pallas K2 and K5 in interpret mode.
"""
import importlib.util
import pathlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_geometric_signed_directed_tpu.ops import build_coo as jx_build_coo
from pytorch_geometric_signed_directed_tpu.ops.pallas import scatter_mxu
from pytorch_geometric_signed_directed_tpu.ops.pallas.bsr_spmm import (
    bsr_from_coo as jx_bsr_from_coo, bsr_spmm as jx_bsr_spmm)
from pytorch_geometric_signed_directed_tpu.spectral import (
    magnet_propagators as jx_magnet_propagators)

from pytorch_geometric_signed_directed_tpu_torch.ops import (
    bsr as bsr_mod, build_coo, layout)
from pytorch_geometric_signed_directed_tpu_torch.ops.cuda import (
    bsr_spmm, scatter_csr)
from pytorch_geometric_signed_directed_tpu_torch.spectral import (
    magnet_propagators)

from test_torch_worker_memory import release_memory  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
L = scatter_csr.PIECE_EDGES
# float64 sums in another order, each rounded once to float32
EMU_TOL = dict(rtol=1e-6, atol=1e-6)
# against the TPU kernels: one-hot matmul order at HIGHEST
F32_TOL = dict(rtol=1e-5, atol=1e-5)


def rowptr_of(lengths):
    return torch.from_numpy(np.concatenate(
        [[0], np.cumsum(lengths)]).astype(np.int32))


def check_plan(rowptr, split, piece_len, min_len=None):
    """``split`` cuts exactly the rows longer than ``min_len`` (default
    ``piece_len``) into pieces of ``piece_len`` edges, in edge order; with
    the rows it leaves whole, it covers every edge once; and it puts every
    uncut row in exactly one row block (at most ``BLOCK_EDGES`` edges)
    or the mid rows (more), in order."""
    min_len = piece_len if min_len is None else min_len
    rp = rowptr.numpy().astype(np.int64)
    length = np.diff(rp)
    rows = split.rows.numpy()
    ptr = split.ptr.numpy()
    pieces = split.pieces.numpy().astype(np.int64)
    assert split.piece_len == piece_len
    assert split.rows.dtype == split.ptr.dtype == split.pieces.dtype == \
        torch.int32
    np.testing.assert_array_equal(rows, np.flatnonzero(length > min_len))
    assert ptr[0] == 0 and len(ptr) == len(rows) + 1
    assert pieces.shape == (ptr[-1], 2)
    covered = np.zeros(rp[-1], np.int64)
    for j, r in enumerate(rows):
        mine = pieces[ptr[j]:ptr[j + 1]]
        assert len(mine) == -(-length[r] // piece_len)
        if length[r] == 0:
            continue
        assert mine[0, 0] == rp[r] and mine[-1, 1] == rp[r + 1]
        np.testing.assert_array_equal(mine[1:, 0], mine[:-1, 1])  # in order
        sizes = mine[:, 1] - mine[:, 0]
        assert np.all(sizes[:-1] == piece_len)
        assert 0 < sizes[-1] <= piece_len
        for a, b in mine:
            covered[a:b] += 1
    for r in np.flatnonzero(length <= min_len):
        covered[rp[r]:rp[r + 1]] += 1
    assert np.all(covered == 1)
    check_blocks(rp, split, length > min_len)


def check_blocks(rp, split, cut):
    """The row blocks and mid rows of ``split`` partition the uncut rows:
    blocks are runs of consecutive short rows (at most half the block
    length each) in order, each within the block shape, and carry their
    rows' edge range; they exist where short rows are at least half of
    the uncut rows, and the other uncut rows are mid rows.  The walked
    rows are the uncut rows of more than WALK_EDGES edges, in order."""
    length = np.diff(rp)
    T, R = scatter_csr.BLOCK_EDGES, scatter_csr.BLOCK_ROWS
    blocks = split.blocks.numpy().astype(np.int64)
    mids = split.mids.numpy()
    assert split.blocks.dtype == split.mids.dtype == torch.int32
    assert blocks.shape[1:] == (4,)
    seen = np.zeros(len(length), np.int64)
    for r0, r1, e0, e1 in blocks:
        assert 0 <= r0 < r1 <= len(length)
        assert (e0, e1) == (rp[r0], rp[r1])
        assert r1 - r0 <= R and e1 - e0 < T
        assert np.all(length[r0:r1] <= T // 2)
        seen[r0:r1] += 1
    assert np.all(np.diff(blocks[:, 0]) > 0)                 # in row order
    short = ~cut & (length <= T // 2)
    if 2 * short.sum() >= (~cut).sum():
        np.testing.assert_array_equal(seen > 0, short)
    else:
        assert len(blocks) == 0
    np.testing.assert_array_equal(mids, np.flatnonzero(~cut & (seen == 0)))
    seen[mids] += 1
    np.testing.assert_array_equal(seen, (~cut).astype(np.int64))
    assert split.walks.dtype == torch.int32
    np.testing.assert_array_equal(
        split.walks.numpy(),
        np.flatnonzero(~cut & (length > scatter_csr.WALK_EDGES)))


# --- the CSR plan ------------------------------------------------------------

T = scatter_csr.BLOCK_EDGES
LENGTHS = {
    "around_the_piece": [L - 1, L, L + 1, 0, 2 * L, 2 * L + 1, 0, 3],
    "empty_rows": [0, 0, 0, 0],
    "no_rows": [],
    "hub": [5, 324_064, 7],
    "only_hubs": [2 * L + 1, 324_064, L + 1],
    "around_a_block": [T - 1, T, T + 1, T // 2, T // 2 + 1, 1, 0, T, 2],
}


@pytest.mark.parametrize("case", sorted(LENGTHS))
def test_plan_covers_every_edge_once_with_short_rows_whole(case):
    rowptr = rowptr_of(np.array(LENGTHS[case], np.int64))
    split = scatter_csr.plan_row_split(rowptr)
    check_plan(rowptr, split, L)


@pytest.mark.parametrize("piece_len", [1, 2, 3, 7, 64])
def test_plan_at_small_piece_lengths(piece_len):
    lengths = np.array([piece_len - 1, piece_len, piece_len + 1, 0,
                        5 * piece_len + 2, 1, 0, 3 * piece_len], np.int64)
    lengths = np.maximum(lengths, 0)
    rowptr = rowptr_of(lengths)
    check_plan(rowptr, scatter_csr.plan_row_split(rowptr, piece_len),
               piece_len)


def test_plan_leaves_rows_at_most_a_piece_long_whole():
    rowptr = rowptr_of(np.array([L - 1, L, 1, 0], np.int64))
    split = scatter_csr.plan_row_split(rowptr)
    assert split.rows.numel() == 0 and split.pieces.shape == (0, 2)
    np.testing.assert_array_equal(split.ptr.numpy(), [0])


def test_plan_of_only_hub_rows_has_no_blocks():
    rowptr = rowptr_of(np.array(LENGTHS["only_hubs"], np.int64))
    split = scatter_csr.plan_row_split(rowptr)
    assert split.blocks.shape == (0, 4) and split.mids.numel() == 0
    assert split.walks.numel() == 0
    assert split.rows.numel() == 3


def test_plan_of_an_empty_csr():
    split = scatter_csr.plan_row_split(rowptr_of(np.array([], np.int64)))
    for t in (split.rows, split.pieces, split.blocks, split.mids,
              split.walks):
        assert t.numel() == 0
    np.testing.assert_array_equal(split.ptr.numpy(), [0])


def test_rows_of_half_a_block_and_more():
    """Rows of at most half of BLOCK_EDGES share blocks; a row of one edge
    more, of BLOCK_EDGES or of one more is a mid row."""
    H = T // 2
    rowptr = rowptr_of(np.array([2, 1, H, H + 1, 3, T, 1, T + 1, 1, 1],
                                np.int64))
    split = scatter_csr.plan_row_split(rowptr)
    check_plan(rowptr, split, L)
    np.testing.assert_array_equal(split.blocks[:, :2].numpy(),
                                  [[0, 3], [4, 5], [6, 7], [8, 10]])
    np.testing.assert_array_equal(split.mids.numpy(), [3, 5, 7])


def test_no_blocks_where_short_rows_are_few():
    """Where fewer than half of the uncut rows are short, every uncut row
    is a mid row (DiGCL's operator: about 20 edges a row)."""
    lengths = np.array([20, 25, 3, 18, 40, 2, 17], np.int64)
    split = scatter_csr.plan_row_split(rowptr_of(lengths))
    check_plan(rowptr_of(lengths), split, L)
    assert split.blocks.shape == (0, 4)
    np.testing.assert_array_equal(split.mids.numpy(), np.arange(7))


def power_law_lengths(n, seed, top=4):
    """Row lengths of a power-law CSR of mostly short rows: 1 to ``top``
    edges by Zipf, a tenth of the rows empty."""
    rng = np.random.default_rng(seed)
    lengths = np.minimum(rng.zipf(2.0, n), top)
    lengths[rng.random(n) < 0.1] = 0
    return lengths.astype(np.int64)


@pytest.mark.parametrize("block_edges,block_rows", [(32, 32), (16, 32),
                                                   (32, 16), (2, 1),
                                                   (3, 5)])
def test_blocks_of_short_rows_within_their_shape(block_edges, block_rows,
                                                 monkeypatch):
    """Power-law short rows beside a hub row and rows around half the
    block length and the block length: every uncut row in one block or in
    the mid rows, in order; blocks hold fewer than ``block_edges`` edges
    (check_plan), at the source's shape and at others that a build of it
    with -DPGSD_BLOCK_EDGES / -DPGSD_BLOCK_ROWS takes."""
    lengths = np.concatenate([power_law_lengths(3000, 5), [324_064],
                              [block_edges // 2, block_edges // 2 + 1,
                               block_edges, 0, 1]])
    rowptr = rowptr_of(lengths)
    monkeypatch.setattr(scatter_csr, "BLOCK_EDGES", block_edges)
    monkeypatch.setattr(scatter_csr, "BLOCK_ROWS", block_rows)
    split = scatter_csr.plan_row_split(rowptr)
    check_plan(rowptr, split, L)
    b = split.blocks.long()
    assert b.shape[0] > 0
    # at the kernels' shapes the rows share blocks: far fewer blocks
    # than rows
    if block_edges >= 16 and block_rows >= 16:
        assert b.shape[0] < 0.3 * len(lengths)


class BlockShapeBuild:
    """The ctypes surface of a build of scatter_csr.cu whose row blocks
    and walked rows are ``shape`` (edges, rows, walk) and whose dual tiles
    its row blocks by ``tile`` lanes: settable entry signatures,
    ``pgsd_csr_block_shape`` and ``pgsd_csr_dual_tile``."""

    def __init__(self, shape, tile=scatter_csr.BLOCK_TILE):
        self.shape, self.tile = shape, tile
        for name in ("pgsd_csr_dual_spmm", "pgsd_csr_pair_spmm",
                     "pgsd_csr_scatter", "pgsd_csr_scatter_indexed"):
            setattr(self, name, types.SimpleNamespace())

    def pgsd_csr_block_shape(self, edges, rows, walk):
        edges._obj.value, rows._obj.value, walk._obj.value = self.shape

    def pgsd_csr_dual_tile(self):
        return self.tile


def test_bind_rejects_another_dual_tile():
    shape = (scatter_csr.BLOCK_EDGES, scatter_csr.BLOCK_ROWS,
             scatter_csr.WALK_EDGES)
    with pytest.raises(RuntimeError, match="tiles row blocks"):
        scatter_csr.bind(BlockShapeBuild(shape, tile=16))


def test_plan_rejects_block_shapes_the_kernels_do_not_take(monkeypatch):
    """A build of the kernels binds only where its row-block shape and
    walked-row length are the plan's (BLOCK_EDGES, BLOCK_ROWS,
    WALK_EDGES); a build of another shape (the A/B script's -D variants)
    binds once the plan's constants are set to it."""
    shape = (scatter_csr.BLOCK_EDGES, scatter_csr.BLOCK_ROWS,
             scatter_csr.WALK_EDGES)
    build = BlockShapeBuild(shape)
    assert scatter_csr.bind(build) is build
    for other in ((16, *shape[1:]), (shape[0], 16, shape[2]),
                  (shape[0] + 1, *shape[1:]), (*shape[:2], 32)):
        with pytest.raises(RuntimeError, match="row blocks"):
            scatter_csr.bind(BlockShapeBuild(other))
    monkeypatch.setattr(scatter_csr, "BLOCK_EDGES", 16)
    scatter_csr.bind(BlockShapeBuild((16, *shape[1:])))
    rowptr = rowptr_of(np.array([7, 1, 8, 9, 2]))
    assert scatter_csr.plan_row_split(rowptr).blocks[:, :2].tolist() == \
        [[0, 2], [2, 3], [4, 5]]


def test_plan_rejects_a_piece_length_below_one():
    with pytest.raises(ValueError, match="positive"):
        scatter_csr.plan_row_split(rowptr_of(np.array([3])), 0)


def load_script(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("direction", ["rows", "cols"])
def test_plan_of_a_power_law_graph(direction):
    """The giant bench's generator at small N: its hub rows (and hub
    columns, the transposed operator's rows) are cut, all else whole."""
    smoke = load_script("chip_smoke", ROOT / "chip_smoke.py")
    row, col = smoke.powerlaw_digraph(20_000, 200_000, 1.0, seed=0)
    key = row if direction == "rows" else col
    length = np.bincount(key, minlength=20_000)
    assert length.max() > 4 * L                     # hubs to cut
    rowptr = rowptr_of(length)
    split = scatter_csr.plan_row_split(rowptr)
    check_plan(rowptr, split, L)
    assert split.rows.numel() == int((length > L).sum())


def test_layouts_carry_the_plan_of_every_rowptr(monkeypatch):
    """build_layout plans the flat rowptr and every block's local one; a
    hub row straddles streamed blocks, so blocks start and end inside it,
    and each block's plan covers the block's own edges."""
    rng = np.random.default_rng(0)
    n, hub = 400, 5000
    row = np.concatenate([rng.integers(0, n, 3000), np.full(hub, 17),
                          np.full(2 * L + 3, 240)])
    col = rng.integers(0, n, len(row))
    flat, _ = layout.build_layout(row, col, n, n, "cpu")
    check_plan(flat.rowptr, flat.row_split, L)
    assert flat.row_split.rows.numel() == 2
    monkeypatch.setattr(layout, "STREAM_THRESHOLD_EDGES", 1000)
    monkeypatch.setattr(layout, "STREAM_BLOCK_EDGES", 1500)
    S, _ = layout.build_layout(row, col, n, n, "cpu")
    assert S.streamed and S.rowptr is None and len(S.blocks) > 4
    straddled = 0
    for b in S.blocks:
        check_plan(b.rowptr, b.split, L)
        assert int(b.rowptr[-1]) == b.e1 - b.e0
        lens = (b.rowptr[1:] - b.rowptr[:-1]).numpy()
        rows = b.row0 + np.arange(len(lens))
        straddled += int(rows[0] == 17 or rows[-1] == 17)
    assert straddled >= 3        # first or last row of several blocks


# --- the kernels' pass structure, emulated -----------------------------------

def emulate(rowptr, msgs, split, out=None, row0=0):
    """What the CSR kernels do with ``split``: one sum per row of each row
    block (within the block's edges) and per mid row, from the row's prior
    value in the accumulate mode and only if it has edges; one float64
    partial per piece; then each cut row's partials added in piece order
    to its prior value (0 in the plain mode) and rounded once.  Every row
    is summed once, by a block, as a mid row or by its pieces.  float64
    here where the kernels keep compensated float32 sums."""
    rp = rowptr.long()
    n = rp.numel() - 1
    accum = out is not None
    out = out.clone() if accum else torch.zeros((n, msgs.shape[1]))
    m = msgs.double()
    summed = torch.zeros(n, dtype=torch.long)

    def row(r, lo, hi):
        a, b = int(rp[r]), int(rp[r + 1])
        assert lo <= a <= b <= hi
        summed[r] += 1
        if accum and a == b:
            return
        prior = out[row0 + r].double() if accum else 0.0
        out[row0 + r] = (prior + m[a:b].sum(0)).float()

    for r0, r1, e0, e1 in split.blocks.long().tolist():
        for r in range(r0, r1):
            row(r, e0, e1)
    for r in split.mids.long().tolist():
        row(r, 0, int(rp[-1]))
    partial = [m[a:b].sum(0) for a, b in split.pieces.long().tolist()]
    for j, r in enumerate(split.rows.tolist()):
        summed[r] += 1
        s = out[row0 + r].double() if accum else torch.zeros(m.shape[1],
                                                             dtype=torch.double)
        for p in range(int(split.ptr[j]), int(split.ptr[j + 1])):
            s = s + partial[p]
        out[row0 + r] = s.float()
    assert torch.all(summed == 1)
    return out


def cut_block(seed, piece_len, width):
    """A block of rows around ``piece_len`` (and a long one, and empty
    ones), its edges' (col, val_a, val_b) and an x."""
    rng = np.random.default_rng(seed)
    lengths = np.array([piece_len - 1, piece_len, piece_len + 1, 0,
                        7 * piece_len + 3, 2, 0, 1], np.int64)
    rowptr = rowptr_of(lengths)
    e, m = int(lengths.sum()), 50
    col = torch.from_numpy(rng.integers(0, m, e).astype(np.int32))
    va, vb = (torch.from_numpy(rng.standard_normal(e).astype(np.float32))
              for _ in range(2))
    x = torch.from_numpy(rng.standard_normal((m, width)).astype(np.float32))
    return rowptr, lengths, col, va, vb, x


@pytest.mark.parametrize("entry", ["dual", "scatter"])
@pytest.mark.parametrize("accum", [False, True])
@pytest.mark.parametrize("piece_len", [4, 16])
def test_emulated_passes_match_the_plain_versions(entry, accum, piece_len):
    rowptr, lengths, col, va, vb, x = cut_block(piece_len, piece_len, 6)
    split = scatter_csr.plan_row_split(rowptr, piece_len)
    assert split.rows.numel() == 2
    rng = np.random.default_rng(1)
    if entry == "dual":
        msgs = scatter_csr._dual_msgs(col, va, vb, x, 3)
    else:
        msgs = torch.from_numpy(
            rng.standard_normal((int(lengths.sum()), 6)).astype(np.float32))
    row0, n = 2, len(lengths)
    out0 = torch.from_numpy(rng.standard_normal((n + 4, 6))
                            .astype(np.float32))
    if accum:
        got = emulate(rowptr, msgs, split, out0, row0)
        want = (scatter_csr.csr_dual_spmm_accum_plain(
            rowptr, col, va, vb, x, 3, out0, row0) if entry == "dual"
            else scatter_csr.csr_scatter_accum_plain(rowptr, msgs, out0,
                                                     row0))
        keep = torch.ones(n + 4, dtype=torch.bool)
        keep[row0:row0 + n] = torch.from_numpy(lengths == 0)
        assert torch.equal(got[keep], out0[keep])    # untouched, bit for bit
    else:
        got = emulate(rowptr, msgs, split)
        want = (scatter_csr.csr_dual_spmm_plain(rowptr, col, va, vb, x, 3)
                if entry == "dual"
                else scatter_csr.csr_scatter_sum_plain(rowptr, msgs))
        assert torch.all(got[torch.from_numpy(lengths == 0)] == 0)
    torch.testing.assert_close(got, want, **EMU_TOL)


@pytest.mark.parametrize("width", [4, 64])
def test_emulated_passes_match_jax_scatter_accum(width):
    """The pass structure on cut rows against the Pallas K2 (interpret
    mode), accumulating into the same prior output."""
    rng = np.random.default_rng(width)
    piece_len = 16
    lengths = np.array([0, 5 * piece_len + 1, 3, piece_len, 0,
                        piece_len + 1, 2 * piece_len], np.int64)
    n, e = len(lengths), int(lengths.sum())
    row = np.repeat(np.arange(n), lengths)
    msgs = rng.standard_normal((e, width)).astype(np.float32)
    plan, perm = scatter_mxu.build_scatter_plan(row, n)
    (msgs_plan,) = scatter_mxu.permute_edge_data(perm, msgs)
    out0 = rng.standard_normal((plan.num_windows * plan.window,
                                width)).astype(np.float32)
    want = scatter_mxu._scatter_accum(
        plan.win, plan.local_rows, jnp.asarray(msgs_plan),
        jnp.asarray(out0), window=plan.window, interpret=True,
        precision=jax.lax.Precision.HIGHEST)
    rowptr = rowptr_of(lengths)
    split = scatter_csr.plan_row_split(rowptr, piece_len)
    got = emulate(rowptr, torch.from_numpy(msgs), split,
                  torch.from_numpy(out0[:n].copy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want)[:n], **F32_TOL)


def short_block(seed, width, m=50):
    """Power-law short rows (empty ones among them) beside a hub row of
    five pieces of 16 edges, rows of 8, 9 and 12 edges (mid rows beside
    blocks of 8 edges) and of 17 (cut into pieces of 16), with their
    edges' (col, val_a, val_b) and an x."""
    rng = np.random.default_rng(seed)
    lengths = np.concatenate([power_law_lengths(400, seed)[:200], [8, 12],
                              [5 * 16 + 3], power_law_lengths(400, seed)
                              [200:], [9, 17, 0, 2]])
    rowptr = rowptr_of(lengths)
    e = int(lengths.sum())
    col = torch.from_numpy(rng.integers(0, m, e).astype(np.int32))
    va, vb = (torch.from_numpy(rng.standard_normal(e).astype(np.float32))
              for _ in range(2))
    x = torch.from_numpy(rng.standard_normal((m, width)).astype(np.float32))
    return rowptr, lengths, col, va, vb, x


@pytest.mark.parametrize("entry", ["dual", "scatter"])
@pytest.mark.parametrize("accum", [False, True])
@pytest.mark.parametrize("width", [1, 5, 32])
def test_emulated_row_blocks_match_the_plain_versions(entry, accum, width,
                                                      monkeypatch):
    """The passes by row block (of 8 edges), mid row and piece (pieces of
    16 edges) against the plain versions: rows without edges untouched in
    the accumulate mode, 0 in the plain one."""
    rowptr, lengths, col, va, vb, x = short_block(width, width)
    monkeypatch.setattr(scatter_csr, "BLOCK_EDGES", 8)
    split = scatter_csr.plan_row_split(rowptr, 16)
    assert split.blocks.shape[0] > 20 and split.mids.numel() == 3
    assert split.rows.numel() == 2
    fa = max(1, width // 2)
    rng = np.random.default_rng(2)
    if entry == "dual":
        msgs = scatter_csr._dual_msgs(col, va, vb, x, fa)
    else:
        msgs = torch.from_numpy(rng.standard_normal(
            (int(lengths.sum()), width)).astype(np.float32))
    row0, n = 3, len(lengths)
    empty = torch.from_numpy(lengths == 0)
    if accum:
        out0 = torch.from_numpy(rng.standard_normal((n + 5, width))
                                .astype(np.float32))
        got = emulate(rowptr, msgs, split, out0, row0)
        want = (scatter_csr.csr_dual_spmm_accum_plain(
            rowptr, col, va, vb, x, fa, out0, row0) if entry == "dual"
            else scatter_csr.csr_scatter_accum_plain(rowptr, msgs, out0,
                                                     row0))
        assert torch.equal(got[row0:row0 + n][empty],
                           out0[row0:row0 + n][empty])
    else:
        got = emulate(rowptr, msgs, split)
        want = (scatter_csr.csr_dual_spmm_plain(rowptr, col, va, vb, x, fa)
                if entry == "dual"
                else scatter_csr.csr_scatter_sum_plain(rowptr, msgs))
        assert torch.all(got[empty] == 0)
    torch.testing.assert_close(got, want, **EMU_TOL)


@pytest.mark.parametrize("width", [1, 17, 64])
def test_emulated_row_blocks_match_jax_scatter_accum(width, monkeypatch):
    """The passes by row block against the Pallas K2 (interpret mode) on
    power-law short rows beside a cut hub row, into the same prior
    output."""
    rng = np.random.default_rng(width)
    lengths = short_block(width, 4)[1]
    n, e = len(lengths), int(lengths.sum())
    row = np.repeat(np.arange(n), lengths)
    msgs = rng.standard_normal((e, width)).astype(np.float32)
    plan, perm = scatter_mxu.build_scatter_plan(row, n)
    (msgs_plan,) = scatter_mxu.permute_edge_data(perm, msgs)
    out0 = rng.standard_normal((plan.num_windows * plan.window,
                                width)).astype(np.float32)
    want = scatter_mxu._scatter_accum(
        plan.win, plan.local_rows, jnp.asarray(msgs_plan),
        jnp.asarray(out0), window=plan.window, interpret=True,
        precision=jax.lax.Precision.HIGHEST)
    rowptr = rowptr_of(lengths)
    monkeypatch.setattr(scatter_csr, "BLOCK_EDGES", 8)
    split = scatter_csr.plan_row_split(rowptr, 16)
    assert split.blocks.shape[0] > 20 and split.mids.numel() == 3
    got = emulate(rowptr, torch.from_numpy(msgs), split,
                  torch.from_numpy(out0[:n].copy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want)[:n], **F32_TOL)


# --- the dual's float32 arithmetic, emulated at widths above 32 lanes ------

KTILE = scatter_csr.BLOCK_TILE  # the lanes of a tile of the wide row blocks


def kahan(acc, cmp, v):
    """csr_common.cuh's kahan_add on float32 numpy lanes."""
    y = v - cmp
    t = acc + y
    return t, (t - acc) - y


def compensated(m, acc):
    """Rows of float32 messages ``m`` [edges, lanes] added to ``acc`` in
    edge order, each compensated; returns the sum and the compensation."""
    cmp = np.zeros_like(acc)
    for v in m:
        acc, cmp = kahan(acc, cmp, v)
    return acc, cmp


def emulate_dual_f32(rowptr, msgs, split, out=None, row0=0, tiled=True):
    """The float32 arithmetic of ``csr_dual_spmm[_accum]`` with ``split``
    at the width of ``msgs``: with ``tiled`` each row block in tiles of
    KTILE lanes (each (row, lane) of the block by one tile), else its rows
    walked over every lane, as each mid row is; a row from its prior value
    in the accumulate mode (only rows with edges), each product added
    compensated; each piece from 0, its (sum - compensation) in float64;
    then each cut row's partials in piece order onto its prior value in
    float64, rounded once.  Returns the output and how often each (row,
    lane) was summed."""
    rp = rowptr.long().numpy()
    n, width = rp.size - 1, msgs.shape[1]
    accum = out is not None
    res = (out.clone() if accum else torch.zeros((n, width))).numpy()
    m = msgs.numpy().astype(np.float32)
    seen = np.zeros((n, width), np.int64)

    def row(r, lanes):
        a, b = rp[r], rp[r + 1]
        seen[r, lanes] += 1
        if accum and a == b:
            return
        prior = (res[row0 + r, lanes] if accum
                 else np.zeros(len(lanes), np.float32))
        res[row0 + r, lanes] = compensated(m[a:b, lanes], prior)[0]

    tiles = [np.arange(c0, min(c0 + KTILE, width))
             for c0 in range(0, width, KTILE)] if tiled else \
        [np.arange(width)]
    for r0, r1, e0, e1 in split.blocks.long().tolist():
        for lanes in tiles:
            for r in range(r0, r1):
                assert e0 <= rp[r] <= rp[r + 1] <= e1
                row(r, lanes)
    for r in split.mids.long().tolist():
        row(r, np.arange(width))
    partial = []
    for a, b in split.pieces.long().tolist():
        acc, cmp = compensated(m[a:b], np.zeros(width, np.float32))
        partial.append(acc.astype(np.float64) - cmp.astype(np.float64))
    for j, r in enumerate(split.rows.tolist()):
        seen[r] += 1
        s = (res[row0 + r].astype(np.float64) if accum
             else np.zeros(width))
        for p in range(int(split.ptr[j]), int(split.ptr[j + 1])):
            s = s + partial[p]
        res[row0 + r] = s.astype(np.float32)
    return torch.from_numpy(res), seen


@pytest.mark.parametrize("tiled", [True, False], ids=["tiled", "walked"])
@pytest.mark.parametrize("accum", [False, True])
@pytest.mark.parametrize("width", [33, 64, 128])
def test_emulated_wide_dual_matches_the_plain_versions(width, accum, tiled,
                                                       monkeypatch):
    """Above 32 lanes: row blocks (of 8 edges) in tiles of 32 lanes or
    walked, mid rows and pieces (of 16 edges) in the kernel's float32
    arithmetic against the plain versions (float64 sums): every (row,
    lane) summed once, rows without edges 0 (plain) or untouched
    (accumulate)."""
    rowptr, lengths, col, va, vb, x = short_block(width + 1, width)
    monkeypatch.setattr(scatter_csr, "BLOCK_EDGES", 8)
    split = scatter_csr.plan_row_split(rowptr, 16)
    assert split.blocks.shape[0] > 20 and split.mids.numel() == 3
    assert split.rows.numel() == 2
    fa = width // 3
    msgs = scatter_csr._dual_msgs(col, va, vb, x, fa)
    n = len(lengths)
    empty = torch.from_numpy(lengths == 0)
    if accum:
        row0 = 2
        out0 = torch.from_numpy(np.random.default_rng(width).standard_normal(
            (n + 4, width)).astype(np.float32))
        got, seen = emulate_dual_f32(rowptr, msgs, split, out0, row0,
                                     tiled)
        want = scatter_csr.csr_dual_spmm_accum_plain(rowptr, col, va, vb, x,
                                                     fa, out0, row0)
        assert torch.equal(got[row0:row0 + n][empty],
                           out0[row0:row0 + n][empty])
        assert torch.equal(got[:row0], out0[:row0])
    else:
        got, seen = emulate_dual_f32(rowptr, msgs, split, tiled=tiled)
        want = scatter_csr.csr_dual_spmm_plain(rowptr, col, va, vb, x, fa)
        assert torch.all(got[empty] == 0)
    assert np.all(seen == 1)
    torch.testing.assert_close(got, want, **EMU_TOL)


@pytest.mark.parametrize("width", [33, 64, 128])
def test_emulated_wide_dual_matches_jax_scatter_accum(width, monkeypatch):
    """The same float32 passes (row blocks in tiles) on the dual's
    messages against the Pallas K2 (interpret mode) accumulating the same
    messages into the same prior output."""
    rowptr, lengths, col, va, vb, x = short_block(width + 2, width)
    msgs = scatter_csr._dual_msgs(col, va, vb, x, width // 2)
    n = len(lengths)
    row = np.repeat(np.arange(n), lengths)
    plan, perm = scatter_mxu.build_scatter_plan(row, n)
    (msgs_plan,) = scatter_mxu.permute_edge_data(perm, msgs.numpy())
    out0 = np.random.default_rng(width).standard_normal(
        (plan.num_windows * plan.window, width)).astype(np.float32)
    want = scatter_mxu._scatter_accum(
        plan.win, plan.local_rows, jnp.asarray(msgs_plan),
        jnp.asarray(out0), window=plan.window, interpret=True,
        precision=jax.lax.Precision.HIGHEST)
    monkeypatch.setattr(scatter_csr, "BLOCK_EDGES", 8)
    split = scatter_csr.plan_row_split(rowptr, 16)
    assert split.blocks.shape[0] > 20 and split.rows.numel() == 2
    got, seen = emulate_dual_f32(rowptr, msgs, split,
                                 torch.from_numpy(out0[:n].copy()))
    assert np.all(seen == 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want)[:n], **F32_TOL)


# --- the BSR plan ------------------------------------------------------------

@pytest.mark.parametrize("n_blocks,n_sms,chunk", [(4096, 132, 16),
                                                  (4096, 1, 2048),
                                                  (100, 132, 1),
                                                  (529, 1, 265)])
def test_block_plan_lists_every_block_row(n_blocks, n_sms, chunk):
    """Every block row in order, cut into pieces of ceil(blocks / (2 *
    SMs)) blocks; a block row without blocks has no piece."""
    assert bsr_spmm.CTAS_PER_SM == 2
    rng = np.random.default_rng(n_blocks)
    per_row = rng.multinomial(n_blocks, rng.dirichlet(np.ones(40) * 0.3))
    per_row[[3, 11]] = 0
    per_row[0] += n_blocks - per_row.sum()
    rowptr = rowptr_of(per_row)
    split = bsr_spmm.plan_block_split(rowptr, n_blocks, n_sms)
    assert split.piece_len == chunk
    check_plan(rowptr, split, chunk, min_len=-1)
    np.testing.assert_array_equal(split.rows.numpy(), np.arange(40))
    assert split.ptr[4] == split.ptr[3] and split.ptr[12] == split.ptr[11]


def unequal_bsr_case(seed, width):
    """Ten block rows of very unequal length (one of 60 blocks, others of
    one to three), with the JAX package's BSR of the same edges."""
    rng = np.random.default_rng(seed)
    n_rows, n_cols = 1280, 60 * 128
    row, col = [], []
    for br, k in enumerate([60, 1, 3, 20, 2, 1, 1, 2, 3, 1]):
        for bc in rng.choice(60, k, replace=False):
            row.append(br * 128 + rng.integers(0, 128, 10))
            col.append(bc * 128 + rng.integers(0, 128, 10))
    row, col = np.concatenate(row), np.concatenate(col)
    val = rng.standard_normal(len(row)).astype(np.float32)
    x = rng.standard_normal((n_cols, width)).astype(np.float32)
    B = bsr_mod.bsr_from_coo(build_coo(row, col, val, n_rows,
                                       num_cols=n_cols, device="cpu"))
    J = jx_bsr_from_coo(jx_build_coo(row, col, val, n_rows, num_cols=n_cols))
    return B, J, x


def emulate_bsr(B, x, split):
    """What K5 does with ``split``: one float32 product per piece (its
    blocks times their x tiles, summed), then each block row's pieces
    added in piece order."""
    f = x.shape[1]
    n_br = B.block_rowptr.numel() - 1
    x_pad = torch.zeros((-(-x.shape[0] // 128) * 128, f))
    x_pad[:x.shape[0]] = x
    tiles = x_pad.view(-1, 128, f)[B.block_cols.long()]
    prods = torch.bmm(B.blocks, tiles)
    partial = [prods[a:b].sum(0) for a, b in split.pieces.long().tolist()]
    out = torch.zeros((n_br, 128, f))
    for br in range(n_br):
        for p in range(int(split.ptr[br]), int(split.ptr[br + 1])):
            out[br] += partial[p]
    return out.view(-1, f)[:B.num_rows]


@pytest.mark.parametrize("n_sms", [132, 2])
def test_emulated_bsr_pieces_match_plain_and_jax(n_sms):
    B, J, x = unequal_bsr_case(0, 8)
    assert B.split is not None
    check_plan(B.block_rowptr, B.split, B.split.piece_len, min_len=-1)
    split = bsr_spmm.plan_block_split(B.block_rowptr, B.blocks.shape[0],
                                      n_sms)
    if n_sms == 2:
        assert split.piece_len == 24          # the 60-block row in 3 pieces
    xt = torch.from_numpy(x)
    got = emulate_bsr(B, xt, split)
    torch.testing.assert_close(
        got, bsr_spmm.bsr_matmul_plain(B.blocks, B.block_rowptr,
                                       B.block_cols, xt, B.num_rows),
        **F32_TOL)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jx_bsr_spmm(J, jnp.asarray(x))),
                               **F32_TOL)


# --- K5's arithmetic: 3xTF32 products on the tensor cores -------------------

def tf32(t):
    """float32 rounded to TF32 (10 mantissa bits) to nearest, ties away from
    zero, as ``cvt.rna.tf32.f32``: add half a unit of the 13 dropped bits
    to the magnitude, then clear them."""
    return ((t.contiguous().view(torch.int32) + 0x1000) & -0x2000).view(
        torch.float32)


def emulate_bsr_tf32(B, x, split, products=3):
    """K5's arithmetic with ``split``: each operand split into hi =
    tf32(v) and lo = tf32(v - hi); every 8-deep K step of a block adds
    a_lo·x_hi, a_hi·x_lo and a_hi·x_hi (``products`` 3) or a_hi·x_hi alone
    (1), each as one tensor-core product: the 8 exact products summed,
    then added to the float32 accumulator with one rounding.  A piece runs
    over its blocks in order; then each block row's pieces are added in
    piece order, as ``emulate_bsr``."""
    f = x.shape[1]
    n_br = B.block_rowptr.numel() - 1
    x_pad = torch.zeros((-(-x.shape[0] // 128) * 128, f))
    x_pad[:x.shape[0]] = x
    tiles = x_pad.view(-1, 128, f)[B.block_cols.long()]
    a_hi = tf32(B.blocks)
    a_lo = tf32(B.blocks - a_hi)
    x_hi = tf32(tiles)
    x_lo = tf32(tiles - x_hi)
    terms = ([(a_lo, x_hi), (a_hi, x_lo), (a_hi, x_hi)] if products == 3
             else [(a_hi, x_hi)])
    partial = []
    for a, b in split.pieces.long().tolist():
        acc = torch.zeros((128, f), dtype=torch.float64)
        for i in range(a, b):
            for k in range(0, 128, 8):
                for ta, tx in terms:
                    acc = (acc + ta[i, :, k:k + 8].double()
                           @ tx[i, k:k + 8].double()).float().double()
        partial.append(acc.float())
    out = torch.zeros((n_br, 128, f))
    for br in range(n_br):
        for p in range(int(split.ptr[br]), int(split.ptr[br + 1])):
            out[br] += partial[p]
    return out.view(-1, f)[:B.num_rows]


def magnet_bsr_case(seed, width, n=1024, degree=24):
    """A MagNet Laplacian's real part on the bsr tier (N=1024, average
    degree 24, q=0.25; every block of the 8 x 8 grid occupied), in both
    packages, with x."""
    rng = np.random.default_rng(seed)
    row, col = rng.integers(0, n, n * degree), rng.integers(0, n, n * degree)
    keep = row != col
    ei = np.stack([row[keep], col[keep]])
    w = rng.uniform(0.5, 1.5, ei.shape[1])
    lap = magnet_propagators(ei, w, q=0.25, num_nodes=n, mode="bsr",
                             device="cpu")
    jlap = jx_magnet_propagators(ei, w, q=0.25, num_nodes=n, mode="bsr")
    x = rng.standard_normal((n, width)).astype(np.float32)
    return lap.re.bsr, jlap.re.bsr, x


BSR_CASES = {"unequal": unequal_bsr_case, "magnet": magnet_bsr_case}


@pytest.mark.parametrize("width", [2, 32, 33])
@pytest.mark.parametrize("case", sorted(BSR_CASES))
def test_emulated_3xtf32_bsr_matches_plain_and_jax(case, width):
    """Three TF32 products a K step, summed in float32 in the kernel's
    piece order, stay within F32_TOL of the plain version and of the
    Pallas K5 at HIGHEST."""
    B, J, x = BSR_CASES[case](width, width)
    if case == "magnet":
        assert B.blocks.shape[0] == 64
    xt = torch.from_numpy(x)
    got = emulate_bsr_tf32(B, xt, B.split)
    torch.testing.assert_close(
        got, bsr_spmm.bsr_matmul_plain(B.blocks, B.block_rowptr,
                                       B.block_cols, xt, B.num_rows),
        **F32_TOL)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jx_bsr_spmm(J, jnp.asarray(x))),
                               **F32_TOL)


@pytest.mark.parametrize("case", sorted(BSR_CASES))
def test_one_tf32_product_misses_f32_tol(case):
    """Why three products: one TF32 product a K step (about 2^-11 of each
    product) misses F32_TOL on the same operators."""
    B, _, x = BSR_CASES[case](32, 32)
    xt = torch.from_numpy(x)
    want = bsr_spmm.bsr_matmul_plain(B.blocks, B.block_rowptr, B.block_cols,
                                     xt, B.num_rows)
    got = emulate_bsr_tf32(B, xt, B.split, products=1)
    excess = (got - want).abs() - (F32_TOL["atol"]
                                   + F32_TOL["rtol"] * want.abs())
    assert float(excess.max()) > 0
    three = emulate_bsr_tf32(B, xt, B.split)
    assert float((three - want).abs().max()) < \
        float((got - want).abs().max()) / 20
