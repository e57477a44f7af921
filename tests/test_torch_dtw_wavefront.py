"""The schedule of the port's split DBA-update kernel
(``csrc/dba_update_split.cu``), modelled in plain PyTorch and held bit for
bit against the port's plain version and the JAX package's split kernel pair
in Pallas interpret mode.

The CUDA kernel runs only on a card.  Its index algebra does not need one:
the model below walks the same bands (lane g owns rows g*64 .. g*64+63 and
keeps their costs), the same skewed steps (lane g does column st - g at step
st, taking the row above its band from lane g-1, or from the previous warp's
last lane), packs the move codes 2 bits each into the same 16-byte words
(word (g, j) holds the codes of band g at column j), and traces the path back
from those words through the same 32-word tiles.  The model's band height and
warp width are parameters, so that small T also runs the hand-over between
warps that the kernel needs only beyond T = 2048.

Tolerance: none.  Every cell is one explicitly rounded subtract, multiply and
add after two comparisons, as in the plain version, and the sums follow its
order, so sums and counts are equal.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from bayesian_ensembling_tpu.ops import dtw_pallas as jdp
from bayesian_ensembling_tpu_torch import _build
from bayesian_ensembling_tpu_torch.ops import dtw as tdtw
from bayesian_ensembling_tpu_torch.ops import dtw_cuda

torch.set_num_threads(1)

BAND, WARP, TILE = 64, 32, 32  # csrc/dba_update_split.cu: kBand, lanes a warp, words a tile
BIG = 3.0e38


def band_cells(centers, series, band=BAND, warp=WARP, clamp=False):
    """The band wavefront of ``csrc/dtw_band.cuh`` (and of the split
    kernel): the ``(N, P, T, band)`` move code of every lane's cells (rows
    past T included) and the ``(N, P, band)`` band costs at column T-1.
    Warps run one after the other, the last lane of each handing its bottom
    row, column by column, to the next warp's first lane.  ``clamp``
    saturates every valid cell but (0, 0) at 3e38, as the cost kernel does."""
    n, t = centers.shape
    p = -(-t // band)
    n_warps = -(-p // warp)
    dtype = centers.dtype
    big = torch.tensor(BIG, dtype=dtype)
    cb = torch.zeros((n, p * band), dtype=dtype)
    cb[:, :t] = centers
    cb = cb.reshape(n, p, band)  # lane g's centre values
    cost = torch.full((n, p, band), BIG, dtype=dtype)
    codes = torch.zeros((n, p, t, band), dtype=torch.int64)
    handed = torch.full((n, t), BIG, dtype=dtype)  # the row above the next warp's bands
    for w in range(n_warps):
        lanes = torch.arange(w * warp, min((w + 1) * warp, p))
        local = lanes - w * warp
        bottom = torch.full((n, len(lanes)), BIG, dtype=dtype)
        up_prev = torch.full_like(bottom, BIG)
        received = handed.clone()
        for st in range(t + len(lanes) - 1):
            j = st - local
            live = (j >= 0) & (j < t)
            jc = j.clamp(0, t - 1)
            up = torch.cat([torch.full((n, 1), BIG, dtype=dtype), bottom[:, :-1]], dim=1)  # __shfl_up_sync
            if w > 0 and st < t:
                up[:, 0] = received[:, st]
            dg, tp = up_prev, up
            sj = series[:, jc]
            for r in range(band):
                lf = cost[:, lanes, r]
                diag_first = dg <= lf  # the tie-break in two steps, only the second waits on tp
                near = torch.where(diag_first, dg, lf)
                keep = near <= tp
                best = torch.where(keep, near, tp)
                d = cb[:, lanes, r] - sj
                v = best + d * d
                if clamp:
                    v = torch.where(v > big, big, v)  # NaN passes
                if r == 0 and w == 0:
                    first = (lanes == 0) & (j == 0)
                    v = torch.where(first, d * d, v)  # cell (0, 0)
                code = torch.where(keep, torch.where(diag_first, 0, 1), 2)
                cost[:, lanes, r] = torch.where(live, v, lf)
                codes[:, lanes[live], jc[live], r] = code[:, live]
                dg, tp = lf, v
            bottom = torch.where(live, cost[:, lanes, band - 1], bottom)
            up_prev = up
            last = len(lanes) - 1
            if live[last] and w + 1 < n_warps:
                handed[:, j[last]] = bottom[:, last]
    return codes, cost


def wavefront_codes(centers, series, band=BAND, warp=WARP):
    """The split kernel's DP: ``(N, P, T, band // 16)`` int64 code words, 16
    codes of 2 bits in each 32-bit part (row g*band + r in part r // 16 at
    bit 2 (r % 16)), and the band costs of the last column."""
    codes, cost = band_cells(centers, series, band, warp)
    n, p, t, _ = codes.shape
    shifts = 2 * (torch.arange(band) % 16)
    parts = (codes << shifts).reshape(n, p, t, band // 16, 16).sum(-1)
    return parts, cost


def unpack(words, i, j, band=BAND):
    """The code of cell (i, j) from the packed words of one pair."""
    r = i % band
    return int(words[i // band, j, r // 16]) >> (2 * (r % 16)) & 3


def traceback(words, series, band=BAND):
    """The first warp's walk from the corner on 32-word tiles of one band,
    reloaded when the path leaves the tile's band or its columns; sums in
    the plain version's order.  A move out of the matrix ends the path.
    Returns (sums, counts, tile loads)."""
    t = series.shape[0]
    add = (lambda a, b: np.float32(a) + np.float32(b)) if series.dtype == torch.float32 else (
        lambda a, b: float(a) + float(b))
    s = series.tolist()
    out_s, out_c = [0.0] * t, [0.0] * t
    ii = jj = t - 1
    tile_band, tile_lo, loads = -1, 0, 0
    acc, cnt = add(0.0, s[jj]), 1.0
    while ii > 0 or jj > 0:
        if ii // band != tile_band or jj < tile_lo:
            tile_band, tile_lo, loads = ii // band, max(0, jj - (TILE - 1)), loads + 1
            staged = range(tile_lo, jj + 1)
        assert jj in staged and jj - tile_lo < TILE
        code = unpack(words, ii, jj, band)
        up, left = code != 1, code != 2
        if (up and ii == 0) or (left and jj == 0):
            break  # the path leaves the matrix (after a NaN): it ends here
        ni = ii - up
        jj -= left
        if ni != ii:
            out_s[ii], out_c[ii] = acc, cnt
            acc, cnt, ii = 0.0, 0.0, ni
        acc = add(acc, s[jj])
        cnt += 1.0
    out_s[ii], out_c[ii] = acc, cnt  # rows above ii were never reached: 0
    return (torch.tensor(np.array(out_s, dtype=np.float64), dtype=series.dtype),
            torch.tensor(out_c, dtype=series.dtype), loads)


def wavefront_dba(centers, series, band=BAND, warp=WARP):
    words, _ = wavefront_codes(centers, series, band, warp)
    out = [traceback(words[k], series[k], band) for k in range(centers.shape[0])]
    return (torch.stack([o[0] for o in out]), torch.stack([o[1] for o in out]),
            [o[2] for o in out], words)


def pairs(t, n=4, dtype=torch.float64):
    rng = np.random.default_rng(70 + t)
    return (torch.from_numpy(rng.normal(size=(n, t))).to(dtype),
            torch.from_numpy(rng.normal(size=(n, t))).to(dtype))


# T = 100 and 165 are not multiples of the band height; (16, 2): bands of 16
# rows (one 32-bit part of a word) and warps of 2 lanes, so that T = 33, 100
# and 165 take 2, 4 and 6 warps.
@pytest.mark.parametrize("band,warp", [(BAND, WARP), (16, 2)])
@pytest.mark.parametrize("t", [2, 9, 33, 100, 165])
def test_wavefront_codes_are_the_plain_move_codes(t, band, warp):
    """Every valid cell's unpacked code equals the plain DP's move code
    (cell (0, 0) has none), and the last column's costs are the plain DP's."""
    c, s = pairs(t)
    words, cost = wavefront_codes(c, s, band, warp)
    assert words.shape == (4, -(-t // band), t, band // 16)
    total, path = tdtw._dtw_scan(c, s, want_path=True)
    for k in range(c.shape[0]):
        for i in range(t):
            for j in range(t):
                if i + j > 0:
                    assert unpack(words[k], i, j, band) == int(path[k, i + j, i])
    assert torch.equal(cost.reshape(4, -1)[:, t - 1], total)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("band,warp", [(BAND, WARP), (16, 2)])
@pytest.mark.parametrize("t", [2, 9, 33, 100, 165])
def test_wavefront_dba_equals_plain_bit_for_bit(t, band, warp, dtype):
    c, s = pairs(t, dtype=dtype)
    got_s, got_c, loads, _ = wavefront_dba(c, s, band, warp)
    want_s, want_c = dtw_cuda.dba_update_batch_reference(c, s)
    assert torch.equal(got_c, want_c) and torch.equal(got_s, want_s)
    # Device memory is waited on once per 32 columns or band of the walk.
    p = -(-t // band)
    assert all(n_loads <= -(-t // TILE) + p for n_loads in loads)


@pytest.fixture
def pallas_interpret(monkeypatch):
    monkeypatch.setattr(jdp, "INTERPRET", True)


@pytest.mark.parametrize("t", [9, 33, 165])
def test_wavefront_dba_equals_jax_split_kernel(pallas_interpret, t):
    """Against the JAX package's split kernel pair in Pallas interpret mode,
    float64: counts equal, sums equal (the same order of additions)."""
    c, s = pairs(t)
    got_s, got_c, _, _ = wavefront_dba(c, s)
    want_s, want_c = jdp.dba_update_batch(jnp.asarray(c.numpy()), jnp.asarray(s.numpy()), impl="split")
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))


def nan_pairs(t, dtype=torch.float64):
    """``pairs(t)`` with NaNs: in row 0 of pair 1's centre (every cell is
    NaN, the walk climbs the last column and leaves the matrix at
    (0, T-1)), in pair 2's series and in the middle of pair 3's centre."""
    c, s = pairs(t, dtype=dtype)
    c[1, 0] = float("nan")
    s[2, t // 3] = float("nan")
    c[3, t // 2] = float("nan")
    return c, s


def assert_equal_nan(got, want):
    assert torch.equal(got.isnan(), want.isnan())
    assert torch.equal(got.nan_to_num(), want.nan_to_num())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("band,warp", [(BAND, WARP), (16, 2)])
@pytest.mark.parametrize("t", [9, 33, 100, 165])
def test_wavefront_dba_after_a_nan_ends_the_path_as_plain(t, band, warp, dtype):
    """After a NaN the walk meets a move out of the matrix and ends there,
    as the plain version's sweep does: sums and counts equal, NaN for NaN,
    rows the path never reached 0.  Forcing left in row 0 instead, as the
    kernel once did, counts all T cells of pair 1's row 0."""
    c, s = nan_pairs(t, dtype)
    got_s, got_c, _, _ = wavefront_dba(c, s, band, warp)
    want_s, want_c = dtw_cuda.dba_update_batch_reference(c, s)
    assert torch.equal(got_c, want_c)
    assert_equal_nan(got_s, want_s)
    assert torch.equal(got_c[1], torch.ones(t, dtype=dtype))


@pytest.mark.parametrize("t", [9, 33, 100])
def test_wavefront_dba_after_a_nan_equals_jax_split_kernel(pallas_interpret, t):
    """The same NaN case against the JAX split kernel pair in Pallas
    interpret mode, float64, bit for bit, on the pairs whose NaN is in the
    centre.  (A NaN in a series makes sums and counts of that pair NaN in
    some rows in the TPU kernels, which weigh the series by the path's mask;
    the plain version and the port skip the cells off the path.)"""
    c, s = nan_pairs(t)
    got_s, got_c, _, _ = wavefront_dba(c, s)
    want_s, want_c = (torch.from_numpy(np.array(a)) for a in jdp.dba_update_batch(
        jnp.asarray(c.numpy()), jnp.asarray(s.numpy()), impl="split"))
    keep = [0, 1, 3]
    assert torch.equal(got_c[keep], want_c[keep])
    assert_equal_nan(got_s[keep], want_s[keep])
    assert want_c[2].isnan().any()


@pytest.mark.parametrize("t,pairs_,gib", [(1980, 812, 0.75), (1032, 1885, 0.5)])
def test_code_scratch_is_a_quarter_byte_a_cell(t, pairs_, gib):
    """One 16-byte word per band of 64 rows and column: at most T^2 / 4
    bytes plus one partial band, for the monthly historical chunk and the
    SSP launch well under a GiB (the byte-per-cell diagonal layout took
    5.93 and 3.74 GiB)."""
    per_pair = dtw_cuda._split_scratch_bytes(t)
    assert per_pair == 16 * -(-t // BAND) * t
    assert t * t / 4 <= per_pair < t * t / 4 + 16 * t
    assert per_pair * pairs_ < gib * 2**30
    assert (2 * t - 1) * t * pairs_ > 3.7 * 2**30


def test_split_shared_memory_mirror():
    """``_split_smem_bytes`` is the launcher's request for one pair, rounded
    up to 16 bytes: 512 bytes of staged words, the centre padded to whole
    bands, the series, and per extra warp a ring of 128 values and two
    counters; one warp up to T = 2048."""
    for t, e in [(165, 4), (1980, 4), (1980, 8), (2048, 8), (2049, 8), (4500, 4)]:
        bands = -(-t // BAND)
        warps = -(-bands // WARP)
        raw = 512 + e * (BAND * bands + t + 128 * (warps - 1)) + 8 * (warps - 1)
        assert dtw_cuda._split_smem_bytes(t, e) == -(-raw // 16) * 16
    assert dtw_cuda.SPLIT_DBA_T_CAP[torch.float64] >= 1980
    assert -(-(-(-dtw_cuda.SPLIT_DBA_T_CAP[torch.float32] // BAND)) // WARP) <= 16
    assert -(-(-(-dtw_cuda.SPLIT_DBA_T_CAP[torch.float64] // BAND)) // WARP) <= 8


# ---------------------------------------------------------------------------
# The fused DBA update (csrc/dba_update.cu) and the squared-DTW cost
# (csrc/dtw_cost.cu) on the same band wavefront (csrc/dtw_band.cuh): band
# heights H of 1 to 16 rows, several warps a pair, and for the DBA update the
# move codes as one stream of 32-bit words a band (the code of row g*H + r at
# column j in slot H*j + r), walked back from the corner with the current
# word and the one below it in registers.

FUSED_HEIGHTS = (1, 2, 4, 8, 16)  # dba_update.cu: H divides 16
SIZES = (1, 2, 31, 32, 33, 86, 165)


def stream_words(t, h):
    """Words of one band's stream: T*H slots of 2 bits, an even count."""
    w = -(-t * h // 16)
    return -(-w // 2) * 2


def pack_streams(codes, h):
    """``(N, P, W)`` stream words from the ``(N, P, T, H)`` codes: slot
    H*j + r holds the code of row r of the band at column j."""
    n, p, t, _ = codes.shape
    w = stream_words(t, h)
    slots = torch.zeros((n, p, 16 * w), dtype=torch.int64)
    slots[:, :, : t * h] = codes.reshape(n, p, t * h)
    return (slots.reshape(n, p, w, 16) << (2 * torch.arange(16))).sum(-1)


def stream_traceback(streams, series, h):
    """dba_update.cu's walk of one pair, then its row sums: (sums, counts,
    moves).  The walk reads the bands' streams as one array, cell
    (g*H + r, j) at slot g*W + H*j + r (W slots a band), and records each
    row's first and last column; a lane a row then sums the row's cells in
    descending column order."""
    t = series.shape[0]
    add = (lambda a, b: np.float32(a) + np.float32(b)) if series.dtype == torch.float32 else (
        lambda a, b: float(a) + float(b))
    s = series.tolist()
    words = streams.reshape(-1).tolist()
    w = 16 * streams.shape[1]
    rows = [None] * t  # (first column, last column); None: never reached
    ii = jj = enter = t - 1
    gs = (ii // h) * w + h * jj + ii % h
    moves = 0
    while gs != 0:  # slot 0 is cell (0, 0)
        assert gs == (ii // h) * w + h * jj + ii % h
        code = words[gs >> 4] >> (2 * (gs & 15)) & 3
        up, left = code != 1, code != 2
        if (up and ii == 0) or (left and jj == 0):
            break  # the path leaves the matrix (after a NaN): it ends here
        nj = jj - left
        if up:
            rows[ii] = (enter, jj)
            enter = nj
        gs -= (h if left else 0) + ((1 if gs & (h - 1) else w - h + 1) if up else 0)
        ii, jj, moves = ii - up, nj, moves + 1
    rows[ii] = (enter, jj)
    out_s, out_c = [0.0] * t, [0.0] * t
    for i, rec in enumerate(rows):
        if rec is not None:
            hi, lo = rec
            acc = add(0.0, s[hi])
            for jc in range(hi - 1, lo - 1, -1):
                acc = add(acc, s[jc])
            out_s[i], out_c[i] = acc, float(hi - lo + 1)
    return (torch.tensor(np.array(out_s, dtype=np.float64), dtype=series.dtype),
            torch.tensor(out_c, dtype=series.dtype), moves)


def fused_dba(centers, series, h, warp=WARP):
    codes, _ = band_cells(centers, series, h, warp)
    streams = pack_streams(codes, h)
    out = [stream_traceback(streams[k], series[k], h) for k in range(centers.shape[0])]
    return (torch.stack([o[0] for o in out]), torch.stack([o[1] for o in out]),
            [o[2] for o in out])


def band_cost(centers, series, h, warp=WARP):
    """dtw_cost.cu: cell (T-1, T-1), held by the lane of row T-1."""
    t = centers.shape[1]
    _, cost = band_cells(centers, series, h, warp, clamp=True)
    return cost[:, (t - 1) // h, (t - 1) % h]


def inputs(t, dtype, kind, n=3):
    """Random pairs, or constant series (every comparison a tie), with a
    NaN in one series of the random case's third pair."""
    rng = np.random.default_rng(300 + t)
    if kind == "constant":
        c, s = np.full((n, t), 0.5), np.full((n, t), -0.25)
    else:
        c, s = rng.normal(size=(n, t)), rng.normal(size=(n, t))
    return torch.from_numpy(c).to(dtype), torch.from_numpy(s).to(dtype)


# Warps of 4 lanes, so that T = 33 at H = 1 takes 9 warps and T = 165 at
# H = 8 takes 6: the hand-over between warps runs at every size.
@pytest.mark.parametrize("kind", ["random", "constant"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("t", SIZES)
@pytest.mark.parametrize("h", FUSED_HEIGHTS)
def test_fused_streams_equal_plain_bit_for_bit(h, t, dtype, kind):
    c, s = inputs(t, dtype, kind)
    got_s, got_c, moves = fused_dba(c, s, h, warp=4)
    want_s, want_c = dtw_cuda.dba_update_batch_reference(c, s)
    assert torch.equal(got_c, want_c) and torch.equal(got_s, want_s)
    # A move of the walk is one cell of the path (the corner excepted).
    if kind == "random":
        assert moves == [int(n) - 1 for n in got_c.sum(1)]


@pytest.mark.parametrize("h", FUSED_HEIGHTS)
def test_fused_streams_hold_the_plain_move_codes(h):
    """Every valid cell's code, read from its stream slot, is the plain
    DP's; one warp of 32 lanes as the kernel at the classic DBA's N."""
    t = 86
    c, s = inputs(t, torch.float64, "random")
    codes, cost = band_cells(c, s, h)
    streams = pack_streams(codes, h)
    assert streams.shape == (3, -(-t // h), stream_words(t, h))
    total, path = tdtw._dtw_scan(c, s, want_path=True)
    i, j = torch.meshgrid(torch.arange(t), torch.arange(t), indexing="ij")
    slot = h * j + i % h
    got = (streams[:, i // h, slot // 16] >> (2 * (slot % 16))) & 3
    want = path[:, i + j, i].long()
    valid = (i + j) > 0
    assert torch.equal(got[:, valid], want[:, valid])
    assert torch.equal(cost.reshape(3, -1)[:, t - 1], total)


@pytest.mark.parametrize("kind", ["random", "constant"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("t", SIZES)
@pytest.mark.parametrize("h", [1, 3, 6, 64])
def test_band_cost_equals_plain_bit_for_bit(h, t, dtype, kind):
    c, s = inputs(t, dtype, kind)
    got = band_cost(c, s, h, warp=4 if h < 64 else WARP)
    want = dtw_cuda.squared_dtw_cost_batch_reference(c, s)
    assert torch.equal(got, want)


def test_band_nan_follows_the_plain_tie_break():
    """A NaN in a series: the two-step tie-break picks the plain version's
    move at every cell, so sums, counts and costs agree, NaN for NaN."""
    t = 33
    c, s = inputs(t, torch.float64, "random")
    s[2, 10] = float("nan")
    c[1, 20] = float("nan")
    for h in (1, 4):
        got_s, got_c, _ = fused_dba(c, s, h, warp=4)
        want_s, want_c = dtw_cuda.dba_update_batch_reference(c, s)
        assert torch.equal(got_c, want_c)
        assert torch.equal(got_s.isnan(), want_s.isnan())
        assert torch.equal(got_s.nan_to_num(), want_s.nan_to_num())
    # Where the path around a NaN reaches the sentinel, the cost kernel
    # returns its 3e38 where the plain version's +inf sentinel leaks through
    # (the TPU cost kernel's sentinel too).
    want = dtw_cuda.squared_dtw_cost_batch_reference(c, s)
    want = torch.where(want > BIG, BIG, want)
    for h in (1, 3):
        got = band_cost(c, s, h, warp=4)
        assert torch.equal(got.isnan(), want.isnan())
        assert torch.equal(got.nan_to_num(), want.nan_to_num())


def test_band_cost_saturates_as_the_tpu_kernel():
    """Valid cells past 3e38 saturate there in float32, cell (0, 0) alone
    excepted, as the TPU cost kernel's jnp.minimum does."""
    c = torch.tensor([[1.5e19, 1.5e19, 0.0]], dtype=torch.float32)
    s = torch.zeros_like(c)
    got = band_cost(c, s, 1, warp=2)
    assert got.item() == np.float32(BIG)
    single = band_cost(c[:, :1], s[:, :1], 1, warp=2)
    assert single.item() == np.float32(1.5e19) ** 2


@pytest.mark.parametrize("t", [2, 9, 21, 33])
def test_band_models_equal_jax_kernels(pallas_interpret, t):
    """Against the JAX package's fused DBA-update kernel (bit for bit) and
    cost kernel (to 1e-10) in Pallas interpret mode, float64."""
    c, s = pairs(t)
    want_s, want_c = jdp.dba_update_batch(jnp.asarray(c.numpy()), jnp.asarray(s.numpy()), impl="fused")
    want = jdp.squared_dtw_cost_batch(jnp.asarray(c.numpy()), jnp.asarray(s.numpy()), lanes=128)
    for h in (1, 2, 8):
        got_s, got_c, _ = fused_dba(c, s, h, warp=4)
        np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
        np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    # The cost kernel's JAX run rounds within an ulp of the exact DP (as in
    # test_torch_dtw_cost.py); the plain version is held bit for bit above.
    for h in (1, 3, 6):
        np.testing.assert_allclose(band_cost(c, s, h, warp=4).numpy(), np.asarray(want), rtol=1e-10)


def test_fused_shared_memory_mirror():
    """``_fused_smem_bytes`` is dba_update.cu's request: per pair, rounded
    up to 16 bytes, the bands' code streams (an even number of words of 16
    codes), the series, a ring of 128 values and two counters between each
    two warps, and a 4-byte record a row; about T^2 / 4 bytes of codes (T^2
    in bytes before)."""
    for t, e, h, ppb in [(165, 4, 8, 4), (165, 4, 2, 1), (86, 8, 1, 1), (944, 4, 16, 1),
                         (932, 8, 16, 1), (33, 4, 16, 3)]:
        bands = -(-t // h)
        warps = -(-bands // WARP)
        raw = 4 * bands * stream_words(t, h) + e * t + (warps - 1) * (128 * e + 8) + 4 * t
        assert dtw_cuda._fused_smem_bytes(t, e, h, ppb) == ppb * (-(-raw // 16) * 16)
    codes = 4 * -(-165 // 8) * stream_words(165, 8)
    assert 165 ** 2 / 4 <= codes < 165 ** 2 / 4 + 16 * 21 and codes < 7.1e3
    assert dtw_cuda.FUSED_DBA_T_CAP == {torch.float32: 944, torch.float64: 932}
    for dtype in (torch.float32, torch.float64):
        e = dtype.itemsize
        cap = dtw_cuda.FUSED_DBA_T_CAP[dtype]
        assert dtw_cuda._fused_smem_bytes(cap, e) <= _build.SMEM_BYTES < dtw_cuda._fused_smem_bytes(cap + 1, e)
    assert dtw_cuda.FUSED_AUTO_T_MAX <= dtw_cuda.FUSED_DBA_T_CAP[torch.float64]


@pytest.mark.parametrize("t", [1, 2, 32, 33, 64, 65, 86, 128, 129, 165, 256, 257, 474, 512, 513, 720, 932])
@pytest.mark.parametrize("e", [4, 8])
def test_fused_layout_rule(t, e):
    """The launcher's layout: a built height, at most 512 threads a block,
    shared memory within the card's; one warp a pair (the smallest height
    that gives at most 32 bands) with pairs sharing a block up to T = 512,
    then H = 16 and one pair a block."""
    h, ppb = dtw_cuda._fused_layout(t, e)
    warps = -(-(-(-t // h)) // WARP)
    assert h in FUSED_HEIGHTS and 32 * warps * ppb <= 512
    assert dtw_cuda._fused_smem_bytes(t, e, h, ppb) <= _build.SMEM_BYTES
    if t <= 512:
        assert warps == 1 and (h == 1 or -(-t // (h // 2)) > 32) and ppb >= 3
    else:
        assert h == 16 and ppb == 1
    assert dtw_cuda._fused_layout(165, 4) == (8, 4)
    assert dtw_cuda._fused_layout(86, 8) == (4, 4)


@pytest.mark.parametrize("t", [1, 2, 31, 32, 33, 86, 165, 512, 513, 1024, 1025, 1032, 1980, 2048,
                               2049, 8192, 8193, 16384])
@pytest.mark.parametrize("e", [4, 8])
def test_cost_layout_and_shared_memory_mirror(t, e):
    """dtw_cost.cu: one warp a pair (H = ceil(T/32) rounded up to a built
    height) while a built height allows it, up to T = 1,024 in float32 and
    512 in float64; then the largest height and several warps a pair; four
    pairs a block up to two warps a pair; per pair the series and the rings."""
    if t > dtw_cuda.DTW_COST_T_CAP[torch.float32 if e == 4 else torch.float64]:
        return
    h, ppb = dtw_cuda._cost_layout(t, e)
    heights = dtw_cuda._COST_HEIGHTS[e]
    warps = -(-(-(-t // h)) // WARP)
    assert h in heights and heights[-1] == (32 if e == 4 else 16)
    if warps == 1:
        assert h == heights[0] or 32 * heights[heights.index(h) - 1] < t
    else:
        assert h == heights[-1] and t > 32 * h
    assert 32 * warps * ppb <= 512 and (warps == 1) == (t <= (1024 if e == 4 else 512))
    assert ppb == (4 if warps <= 2 else 1)
    raw = e * t + (warps - 1) * (128 * e + 8)
    assert dtw_cuda._cost_smem_bytes(t, e) == ppb * (-(-raw // 16) * 16) <= _build.SMEM_BYTES
    assert dtw_cuda._cost_layout(165, 4) == (6, 4) and dtw_cuda._cost_layout(86, 8) == (3, 4)
    assert dtw_cuda._cost_layout(1980, 4) == (32, 4) and dtw_cuda._cost_layout(1980, 8) == (16, 1)
