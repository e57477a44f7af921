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
from bayesian_ensembling_tpu_torch.ops import dtw as tdtw
from bayesian_ensembling_tpu_torch.ops import dtw_cuda

torch.set_num_threads(1)

BAND, WARP, TILE = 64, 32, 32  # csrc/dba_update_split.cu: kBand, lanes a warp, words a tile
BIG = 3.0e38


def wavefront_codes(centers, series, band=BAND, warp=WARP):
    """The kernel's DP: ``(N, P, T, band // 16)`` int64 code words, 16 codes of 2 bits
    in each 32-bit part (row g*band + r in part r // 16 at bit 2 (r % 16)),
    and the band costs of the last column.  Warps run one after the other,
    the last lane of each handing its bottom row, column by column, to the
    next warp's first lane."""
    n, t = centers.shape
    p = -(-t // band)
    n_warps = -(-p // warp)
    dtype = centers.dtype
    cb = torch.zeros((n, p * band), dtype=dtype)
    cb[:, :t] = centers
    cb = cb.reshape(n, p, band)  # the kernel's cb[r * p + g]
    cost = torch.full((n, p, band), BIG, dtype=dtype)
    codes = torch.zeros((n, p, t, band), dtype=torch.int64)
    handed = torch.full((n, t), BIG, dtype=dtype)  # the row above the next warp's bands
    for w in range(n_warps):
        lanes = torch.arange(w * warp, min((w + 1) * warp, p))
        local = lanes - w * warp
        bottom = torch.full((n, len(lanes)), BIG, dtype=dtype)
        up_prev = torch.full_like(bottom, BIG)
        received = handed.clone()
        for st in range(t + warp - 1):
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
    the plain version's order.  Returns (sums, counts, tile loads)."""
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
        if ii == 0:
            code = 1
        elif jj == 0:
            code = 2
        ni = ii - (code != 1)
        jj -= code != 2
        if ni != ii:
            out_s[ii], out_c[ii] = acc, cnt
            acc, cnt, ii = 0.0, 0.0, ni
        acc = add(acc, s[jj])
        cnt += 1.0
    out_s[0], out_c[0] = acc, cnt
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
