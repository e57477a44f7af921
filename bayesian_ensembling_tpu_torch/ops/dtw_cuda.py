"""The DBA-update kernels (``csrc/dba_update.cu``, ``csrc/dba_update_split.cu``),
the squared-DTW cost kernel (``csrc/dtw_cost.cu``) and their plain versions.

Counterpart of ``bayesian_ensembling_tpu/ops/dtw_pallas.py``.
:func:`squared_dtw_cost_batch` is the cost of each (centre, series) pair
alone, with no path.  ``dba_update_batch(impl=...)`` gives, for each pair,
the squared-DTW alignment's aligned-value sums and visit counts per centre
slot.  Both DBA-update kernels compute the same function:

  * ``"fused"`` (``dba_update.cu``) keeps the move codes, 2 bits each, in
    shared memory, which caps T (:data:`FUSED_DBA_T_CAP`: 944 in float32);
    ``"auto"`` sends it T up to :data:`FUSED_AUTO_T_MAX`;
  * ``"split"`` (``dba_update_split.cu``) writes them, 2 bits each, to a
    device-memory scratch, so only the series and the centre stay on chip
    (:data:`SPLIT_DBA_T_CAP`: 28,134 in float32).  It takes the monthly
    T = 1032 and 1980.

CUDA tensors go to the kernels; CPU tensors go to the plain versions
(:func:`dba_update_batch_reference`, for either impl, and
:func:`squared_dtw_cost_batch_reference`).
"""

from __future__ import annotations

import typing as tp

import torch

from bayesian_ensembling_tpu_torch import _build
from bayesian_ensembling_tpu_torch.ops.dtw import _backtrack_accumulate, _dtw_scan

__all__ = [
    "DTW_COST_T_CAP",
    "FUSED_AUTO_T_MAX",
    "FUSED_DBA_T_CAP",
    "SPLIT_DBA_T_CAP",
    "SPLIT_SCRATCH_BYTES",
    "dba_update_batch",
    "dba_update_batch_reference",
    "fused_dba_fits",
    "split_dba_fits",
    "squared_dtw_cost_batch",
    "squared_dtw_cost_batch_reference",
]


# dtw_band.cuh: columns in flight between two warps of a pair.
_RING = 128

# Band heights (rows a lane) each kernel is built for: the DBA update's
# divide 16 (a band column is one field of one 32-bit code word); the cost
# kernel's are the powers of two, to 32 in float32 only (float64 would
# spill), and 3 and 6 for the paths' T = 86 and 165; any other T rounds up.
_FUSED_HEIGHTS = (1, 2, 4, 8, 16)
_COST_HEIGHTS = {4: (1, 2, 3, 4, 6, 8, 16, 32), 8: (1, 2, 3, 4, 6, 8, 16)}
# Threads a block at most (both kernels' __launch_bounds__); pairs a block
# when a pair is one warp.
_MAX_THREADS, _PAIRS_PER_BLOCK = 512, 4


def _bands(t: int, h: int) -> int:
    return -(-t // h)


def _warps(t: int, h: int) -> int:
    return -(-_bands(t, h) // 32)


def _ring_bytes(warps: int, itemsize: int) -> int:
    """dtw_band.cuh's ring between the warps of one pair and its two counters."""
    return (warps - 1) * (itemsize * _RING + 8)


def _round16(n: int) -> int:
    return -(-n // 16) * 16


def _stream_words(t: int, h: int) -> int:
    """``dba_update.cu``: 32-bit words of one band's code stream (T*H codes
    of 2 bits), rounded up to an even count."""
    w = -(-t * h // 16)
    return -(-w // 2) * 2


def _fused_pair_bytes(t: int, itemsize: int, h: int) -> int:
    """``dba_update.cu``, one pair: the code streams of its bands, the series,
    the rings between its warps and the path's row records (4 bytes a row),
    rounded up to 16 bytes."""
    return _round16(4 * _bands(t, h) * _stream_words(t, h) + itemsize * t
                    + _ring_bytes(_warps(t, h), itemsize) + 4 * t)


def _fused_smem_bytes(t: int, itemsize: int, h: int = 16, ppb: int = 1) -> int:
    """``dba_update.cu``'s request for ``ppb`` pairs a block of band height
    ``h``; by default the layout of the largest T (H = 16, one pair)."""
    return ppb * _fused_pair_bytes(t, itemsize, h)


def _fused_layout(t: int, itemsize: int) -> tp.Tuple[int, int]:
    """(band height H, pairs a block) of ``dba_update.cu`` for pairs of T.

    The smallest H that makes a pair one warp (at most 32 bands), up to
    ``_PAIRS_PER_BLOCK`` pairs a block as shared memory allows; past
    T = 512, H = 16 and one pair a block of several warps.  The same rule
    serves the subgradient DBA's N = 112, fewer pairs than SMs, where one
    pair's chain is the time, and the classic DBA's N = 3,248, where the
    instructions a cell are: on the H100 (``utils/dtw_kernel_times.py``)
    a pair of several warps with smaller bands was slower at N = 112 too
    (T = 165: 0.100 ms with H = 4 and two warps against 0.038 ms with
    H = 8 and one), as the hand-over between warps costs more than the
    shorter chain saves.
    """
    h = next((h for h in _FUSED_HEIGHTS if _bands(t, h) <= 32), 16)
    ppb = 1
    if _warps(t, h) == 1:
        ppb = max(1, min(_PAIRS_PER_BLOCK, _build.SMEM_BYTES // _fused_pair_bytes(t, itemsize, h)))
    return h, ppb


# dba_update_split.cu: rows per lane (the 2-bit codes of one band column are
# one 16-byte word), columns in flight between two warps of a pair, and the
# traceback's staged words.
_SPLIT_BAND, _SPLIT_RING, _SPLIT_TILE_BYTES = 64, 128, 32 * 16


def _split_smem_bytes(t: int, itemsize: int) -> int:
    """``dba_update_split.cu``, one pair, rounded up to 16 bytes: the
    traceback's 32 code words, the centre in band-major order (64 rows a
    band), the series, and a ring of 128 values and two counters between
    each two warps of a pair (a warp takes 32 bands)."""
    bands = -(-t // _SPLIT_BAND)
    warps = -(-bands // 32)
    raw = (_SPLIT_TILE_BYTES + itemsize * (_SPLIT_BAND * bands + t + _SPLIT_RING * (warps - 1))
           + 8 * (warps - 1))
    return -(-raw // 16) * 16


def _split_scratch_bytes(t: int) -> int:
    """Move-code scratch of one pair in ``dba_update_split.cu``: one 16-byte
    word (64 codes of 2 bits) per band of 64 rows and column, about T^2 / 4
    bytes."""
    return 16 * -(-t // _SPLIT_BAND) * t


def _cost_layout(t: int, itemsize: int) -> tp.Tuple[int, int]:
    """(band height H, pairs a block) of ``dtw_cost.cu``.

    One warp a pair while a built height gives at most 32 bands (T up to
    1,024 in float32, 512 in float64): H the smallest such, four pairs a
    block.  Beyond, the largest height and ceil(T / 32H) warps a pair; four
    pairs a block while a pair takes at most two warps, else one.  On the
    H100 (``utils/dtw_kernel_times.py``, float32, T = 1980) H = 32 with two
    warps a pair and four pairs a block took 2.998 ms, against 3.850 ms
    with one pair a block and 3.351 / 4.052 ms for H = 16 with four warps
    a pair and one / four pairs a block.
    """
    heights = _COST_HEIGHTS[itemsize]
    h = next((h for h in heights if 32 * h >= t), heights[-1])
    return h, (_PAIRS_PER_BLOCK if _warps(t, h) <= 2 else 1)


def _cost_smem_bytes(t: int, itemsize: int) -> int:
    """``dtw_cost.cu``'s request: per pair of the block the series and the
    rings between its warps, rounded up to 16 bytes."""
    h, ppb = _cost_layout(t, itemsize)
    return ppb * _round16(itemsize * t + _ring_bytes(_warps(t, h), itemsize))


# Largest T each kernel takes, by dtype: shared memory for the DBA updates
# (the fused one at H = 16, one pair a block), threads a block for the cost
# kernel (16 warps of 32 bands of its largest height).
FUSED_DBA_T_CAP = {
    d: _build.largest_t(lambda t, e=d.itemsize: _fused_smem_bytes(t, e))
    for d in (torch.float32, torch.float64)
}
SPLIT_DBA_T_CAP = {
    d: _build.largest_t(lambda t, e=d.itemsize: _split_smem_bytes(t, e))
    for d in (torch.float32, torch.float64)
}
DTW_COST_T_CAP = {
    d: _MAX_THREADS * max(_COST_HEIGHTS[d.itemsize]) for d in (torch.float32, torch.float64)
}
# The largest T that impl="auto" sends to the fused kernel; the split kernel
# takes the rest.  The fused kernel's cap is higher, but at T = 720 it was
# not faster than the split kernel (utils/dtw_kernel_times.py, PERF.md).
FUSED_AUTO_T_MAX = 474
# Bound on the split kernel's move-code scratch: about T^2 / 4 bytes per pair
# (0.98 MB at T = 1980, so the monthly historical chunk of 28 x 29 = 812
# pairs takes 0.74 GiB); beyond it the wrapper chunks.  8 GiB is a tenth of
# the H100's memory.
SPLIT_SCRATCH_BYTES = 8 << 30


def fused_dba_fits(t: int, dtype: torch.dtype = torch.float32) -> bool:
    """Whether the fused kernel (move codes in shared memory) takes T."""
    return t <= FUSED_DBA_T_CAP[dtype]


def split_dba_fits(t: int, dtype: torch.dtype = torch.float32) -> bool:
    """Whether the split kernel (move codes in device memory) takes T."""
    return t <= SPLIT_DBA_T_CAP[dtype]


def dba_update_batch_reference(
    centers: torch.Tensor, series: torch.Tensor
) -> tp.Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch DBA update: the wavefront DP with its move codes, then
    the backward on-path sweep, over all ``N`` pairs at once."""
    _, path = _dtw_scan(centers, series, want_path=True)
    return _backtrack_accumulate(path, series)


def _launch_split(centers, series, sums, counts):
    n, t = centers.shape
    per_pair = _split_scratch_bytes(t)
    chunk = max(1, min(n, SPLIT_SCRATCH_BYTES // per_pair))
    codes = torch.empty(chunk * per_pair, dtype=torch.uint8, device=centers.device)
    symbol = f"bet_dba_update_split_{_build.symbol_suffix(centers.dtype)}"
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        _build.launch(
            "dba_update_split", symbol,
            centers[lo:hi].data_ptr(), series[lo:hi].data_ptr(), sums[lo:hi].data_ptr(),
            counts[lo:hi].data_ptr(), codes.data_ptr(), hi - lo, t,
        )


def dba_update_batch(
    centers: torch.Tensor, series: torch.Tensor, impl: str = "auto"
) -> tp.Tuple[torch.Tensor, torch.Tensor]:
    """One DBA alignment pass for a batch of (centre, series) problems.

    Args:
      centers, series: ``(N, T)`` problem pairs.
      impl: ``"auto"`` (the fused kernel up to :data:`FUSED_AUTO_T_MAX`,
        else the split kernel), or ``"fused"`` / ``"split"`` to force one.  Each is held to
        its own size cap on every device, and raises beyond it.

    Returns:
      (sums, counts): ``(N, T)`` aligned-value sums and visit counts per
      centre slot.  On CUDA the kernels take float32 or float64.
    """
    if centers.shape != series.shape or centers.dim() != 2:
        raise ValueError(f"expected two (N, T) tensors, got {centers.shape} and {series.shape}")
    if impl not in ("auto", "fused", "split"):
        raise ValueError(f"unknown impl {impl!r}; options: 'auto', 'fused', 'split'")
    n, t = centers.shape
    if t == 1:
        # Trivial alignment: the single centre slot is visited once.
        return series.to(centers.dtype).clone(), torch.ones_like(centers)
    if centers.dtype not in FUSED_DBA_T_CAP:
        raise TypeError(f"dba_update_batch takes float32 or float64 tensors, got {centers.dtype}")
    if impl == "auto":
        fused = t <= FUSED_AUTO_T_MAX and fused_dba_fits(t, centers.dtype)
        impl = "fused" if fused else "split"
    if impl == "fused" and not fused_dba_fits(t, centers.dtype):
        raise ValueError(
            f"T={t} exceeds the fused DBA kernel's shared-memory cap "
            f"({FUSED_DBA_T_CAP[centers.dtype]} in {centers.dtype}; it needs "
            f"{_fused_smem_bytes(t, centers.element_size())} bytes of the "
            f"{_build.SMEM_BYTES}); use impl='split'"
        )
    if impl == "split" and not split_dba_fits(t, centers.dtype):
        raise ValueError(
            f"T={t} exceeds the split DBA kernel's shared-memory cap "
            f"({SPLIT_DBA_T_CAP[centers.dtype]} in {centers.dtype}; it needs "
            f"{_split_smem_bytes(t, centers.element_size())} bytes of the {_build.SMEM_BYTES})"
        )
    if centers.device.type == "cpu":
        return dba_update_batch_reference(centers, series)
    _build.check_cuda("dba_update_batch", centers, series)
    sums = torch.empty_like(centers)
    counts = torch.empty_like(centers)
    if impl == "split":
        _launch_split(centers, series, sums, counts)
    else:
        _launch_fused(centers, series, sums, counts, *_fused_layout(t, centers.element_size()))
    return sums, counts


def _launch_fused(centers, series, sums, counts, h, ppb):
    """``dba_update.cu`` at band height ``h`` with ``ppb`` pairs a block."""
    n, t = centers.shape
    _build.launch(
        "dba_update", f"bet_dba_update_{_build.symbol_suffix(centers.dtype)}",
        centers.data_ptr(), series.data_ptr(), sums.data_ptr(), counts.data_ptr(), n, t, h, ppb,
    )


def squared_dtw_cost_batch_reference(centers: torch.Tensor, series: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch squared-DTW costs: the wavefront DP over all ``N``
    pairs at once, with no move codes."""
    return _dtw_scan(centers, series, want_path=False)[0]


def squared_dtw_cost_batch(centers: torch.Tensor, series: torch.Tensor) -> torch.Tensor:
    """Squared-DTW cost of each of ``N`` equal-length alignment problems.

    Args:
      centers, series: ``(N, T)`` problem pairs.

    Returns:
      ``(N,)`` costs, cell (T-1, T-1) of each pair's DP; on CUDA the kernel
      takes float32 or float64 and T up to :data:`DTW_COST_T_CAP`.
    """
    if centers.shape != series.shape or centers.dim() != 2:
        raise ValueError(f"expected two (N, T) tensors, got {centers.shape} and {series.shape}")
    if centers.device.type == "cpu":
        return squared_dtw_cost_batch_reference(centers, series)
    _build.check_cuda("squared_dtw_cost_batch", centers, series)
    n, t = centers.shape
    _build.symbol_suffix(centers.dtype)  # raises for a type the kernel lacks
    if t > DTW_COST_T_CAP[centers.dtype]:
        raise ValueError(
            f"T={t} exceeds the DTW cost kernel's cap ({DTW_COST_T_CAP[centers.dtype]} in "
            f"{centers.dtype}: {_MAX_THREADS // 32} warps of 32 bands of "
            f"{max(_COST_HEIGHTS[centers.element_size()])} rows)"
        )
    out = torch.empty((n,), dtype=centers.dtype, device=centers.device)
    _launch_cost(centers, series, out, *_cost_layout(t, centers.element_size()))
    return out


def _launch_cost(centers, series, out, h, ppb):
    """``dtw_cost.cu`` at band height ``h`` with ``ppb`` pairs a block."""
    n, t = centers.shape
    _build.launch("dtw_cost", f"bet_dtw_cost_{_build.symbol_suffix(centers.dtype)}",
                  centers.data_ptr(), series.data_ptr(), out.data_ptr(), n, t, h, ppb)
