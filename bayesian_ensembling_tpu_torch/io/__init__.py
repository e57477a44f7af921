"""IO: netCDF (h5py) reading/writing, CF time utilities (host code, numpy).

``netcdf`` imports h5py only when a file is read or written, so this
package imports without it."""

from bayesian_ensembling_tpu_torch.io import netcdf, timeutils
from bayesian_ensembling_tpu_torch.io.netcdf import open_dataarray, save_dataarray

__all__ = ["netcdf", "timeutils", "open_dataarray", "save_dataarray"]
