"""Create GMST (global-mean surface temperature) series from gridded tas,
on the port.

The port's copy of ``data_download/create_gmst.py``: the cos(latitude)
area-weighted mean over latitude and longitude of a gridded ``tas`` field
(NaN cells left out), written as one netCDF GMST file per input.

Usage:
    python -m bayesian_ensembling_tpu_torch.cli.create_gmst OUT_DIR FILE [FILE ...]
"""

import argparse
import os

import numpy as np

from bayesian_ensembling_tpu_torch.coords import DimArray

__all__ = ["area_weighted_mean", "create_gmst_file", "main"]


def area_weighted_mean(da: DimArray) -> DimArray:
    """cos(latitude)-weighted mean over (latitude, longitude): the weights
    broadcast over longitude and are normalised over the spatial cells that
    hold a value."""
    lat_ax = da.axis_of("latitude")
    lon_ax = da.axis_of("longitude")
    lat = da.get_coord("latitude").astype(np.float64)
    shape = [1] * da.ndim
    shape[lat_ax] = len(lat)
    w = np.broadcast_to(np.cos(np.deg2rad(lat)).reshape(shape), da.shape)
    num = np.nansum(da.values * w, axis=(lat_ax, lon_ax))
    den = np.sum(np.where(np.isnan(da.values), 0.0, w), axis=(lat_ax, lon_ax))
    dims = tuple(d for d in da.dims if d not in ("latitude", "longitude"))
    coords = {k: v for k, v in da.coords.items() if k in dims}
    return DimArray(num / den, dims, coords, name=(da.name or "tas") + "_gmst")


def create_gmst_file(in_path: str, out_dir: str) -> str:
    from bayesian_ensembling_tpu_torch.io import netcdf

    gmst = area_weighted_mean(netcdf.open_dataarray(in_path))
    out_path = os.path.join(out_dir, os.path.basename(in_path).replace(".nc", "_gmst.nc"))
    netcdf.save_dataarray(out_path, gmst, var_name="tas")
    return out_path


def main(argv=None):
    """Write the GMST file of each input; returns the paths written."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("out_dir")
    ap.add_argument("files", nargs="+")
    args = ap.parse_args(argv)
    os.makedirs(args.out_dir, exist_ok=True)
    written = []
    for f in args.files:
        written.append(create_gmst_file(f, args.out_dir))
        print(written[-1])
    return written


if __name__ == "__main__":
    main()
