"""Host-side time helpers (numpy); the netCDF reader is ROADMAP.md item A7b."""

from bayesian_ensembling_tpu_torch.io import timeutils

__all__ = ["timeutils"]
