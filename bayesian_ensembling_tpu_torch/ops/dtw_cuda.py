"""The DBA-update kernels (``csrc/dba_update.cu``, ``csrc/dba_update_split.cu``),
the squared-DTW cost kernel (``csrc/dtw_cost.cu``) and their plain versions.

Counterpart of ``bayesian_ensembling_tpu/ops/dtw_pallas.py``.
:func:`squared_dtw_cost_batch` is the cost of each (centre, series) pair
alone, with no path.  ``dba_update_batch(impl=...)`` gives, for each pair,
the squared-DTW alignment's aligned-value sums and visit counts per centre
slot.  Both DBA-update kernels compute the same function:

  * ``"fused"`` (``dba_update.cu``) keeps the move codes in shared memory,
    which caps T (:data:`FUSED_DBA_T_CAP`: 474 in float32);
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


def _fused_smem_bytes(t: int, itemsize: int) -> int:
    """``dba_update.cu``: the series, three diagonals and T^2 move codes."""
    return itemsize * (t + 3 * (t + 1)) + t * t


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


def _cost_smem_bytes(t: int, itemsize: int) -> int:
    """``dtw_cost.cu``: the series, the centre and three diagonals."""
    return itemsize * (2 * t + 3 * (t + 1))


# Largest T each kernel takes, by dtype (shared memory; the fused kernel also
# runs one thread per row, at most 1024).
FUSED_DBA_T_CAP = {
    d: _build.largest_t(lambda t, e=d.itemsize: _fused_smem_bytes(t, e), t_max=1024)
    for d in (torch.float32, torch.float64)
}
SPLIT_DBA_T_CAP = {
    d: _build.largest_t(lambda t, e=d.itemsize: _split_smem_bytes(t, e))
    for d in (torch.float32, torch.float64)
}
DTW_COST_T_CAP = {
    d: _build.largest_t(lambda t, e=d.itemsize: _cost_smem_bytes(t, e))
    for d in (torch.float32, torch.float64)
}
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
      impl: ``"auto"`` (the fused kernel when T fits it, else the split
        kernel), or ``"fused"`` / ``"split"`` to force one.  Each is held to
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
        impl = "fused" if fused_dba_fits(t, centers.dtype) else "split"
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
        _build.launch(
            "dba_update",
            f"bet_dba_update_{_build.symbol_suffix(centers.dtype)}",
            centers.data_ptr(), series.data_ptr(), sums.data_ptr(), counts.data_ptr(), n, t,
        )
    return sums, counts


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
    symbol = f"bet_dtw_cost_{_build.symbol_suffix(centers.dtype)}"
    if t > DTW_COST_T_CAP[centers.dtype]:
        raise ValueError(
            f"T={t} exceeds the DTW cost kernel's shared-memory cap "
            f"({DTW_COST_T_CAP[centers.dtype]} in {centers.dtype}; it needs "
            f"{_cost_smem_bytes(t, centers.element_size())} bytes of the {_build.SMEM_BYTES})"
        )
    out = torch.empty((n,), dtype=centers.dtype, device=centers.device)
    _build.launch("dtw_cost", symbol, centers.data_ptr(), series.data_ptr(), out.data_ptr(), n, t)
    return out
