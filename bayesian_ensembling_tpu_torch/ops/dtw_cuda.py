"""The DBA-update kernel (``csrc/dba_update.cu``) and its plain version.

Counterpart of ``bayesian_ensembling_tpu/ops/dtw_pallas.py``'s
``dba_update_batch(impl="fused")``: for each (centre, series) pair, the
squared-DTW alignment and the aligned-value sums and visit counts per centre
slot.  CUDA tensors go to the kernel; CPU tensors go to
:func:`dba_update_batch_reference`.
"""

from __future__ import annotations

import typing as tp

import torch

from bayesian_ensembling_tpu_torch import _build
from bayesian_ensembling_tpu_torch.ops.dtw import _backtrack_accumulate, _dtw_scan

__all__ = ["dba_update_batch", "dba_update_batch_reference"]


def dba_update_batch_reference(
    centers: torch.Tensor, series: torch.Tensor
) -> tp.Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch DBA update: the wavefront DP with its move codes, then
    the backward on-path sweep, over all ``N`` pairs at once."""
    _, path = _dtw_scan(centers, series, want_path=True)
    return _backtrack_accumulate(path, series)


def dba_update_batch(
    centers: torch.Tensor, series: torch.Tensor
) -> tp.Tuple[torch.Tensor, torch.Tensor]:
    """One DBA alignment pass for a batch of (centre, series) problems.

    Args:
      centers, series: ``(N, T)`` problem pairs.

    Returns:
      (sums, counts): ``(N, T)`` aligned-value sums and visit counts per
      centre slot.  On CUDA the kernel takes float32 or float64 and
      T up to its shared-memory capacity (about 470 in float32); it raises
      beyond that.
    """
    if centers.shape != series.shape or centers.dim() != 2:
        raise ValueError(f"expected two (N, T) tensors, got {centers.shape} and {series.shape}")
    n, t = centers.shape
    if t == 1:
        # Trivial alignment: the single centre slot is visited once.
        return series.to(centers.dtype).clone(), torch.ones_like(centers)
    if centers.device.type == "cpu":
        return dba_update_batch_reference(centers, series)
    _build.check_cuda("dba_update_batch", centers, series)
    sums = torch.empty_like(centers)
    counts = torch.empty_like(centers)
    _build.launch(
        "dba_update",
        f"bet_dba_update_{_build.symbol_suffix(centers.dtype)}",
        centers.data_ptr(), series.data_ptr(), sums.data_ptr(), counts.data_ptr(), n, t,
    )
    return sums, counts
