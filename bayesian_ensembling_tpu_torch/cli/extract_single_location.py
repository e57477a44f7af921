"""Extract the nearest-gridpoint series at a target location, on the port.

The port's copy of ``data_download/extract_single_location.py`` (52.5N, 0E
by default): the nearest latitude / longitude gridpoint of a gridded
``tas`` field, either longitude convention, written as one
single-location netCDF file per input.

Usage:
    python -m bayesian_ensembling_tpu_torch.cli.extract_single_location OUT_DIR FILE [FILE ...]
        [--lat 52.5] [--lon 0.0]
"""

import argparse
import os

import numpy as np

from bayesian_ensembling_tpu_torch.coords import DimArray

__all__ = ["extract_location", "main"]


def extract_location(da: DimArray, lat: float, lon: float) -> DimArray:
    lats = da.get_coord("latitude").astype(np.float64)
    lons = da.get_coord("longitude").astype(np.float64)
    i = int(np.argmin(np.abs(lats - lat)))
    # 0-360 and -180..180 longitudes alike.
    dl = np.minimum(np.abs(lons - lon), np.abs(lons - lon - 360.0))
    dl = np.minimum(dl, np.abs(lons - lon + 360.0))
    j = int(np.argmin(dl))
    out = da.isel(latitude=i, longitude=j)
    out.name = (da.name or "tas") + "_single_location"
    return out


def main(argv=None):
    """Write the single-location file of each input; returns the paths."""
    from bayesian_ensembling_tpu_torch.io import netcdf

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("out_dir")
    ap.add_argument("files", nargs="+")
    ap.add_argument("--lat", type=float, default=52.5)
    ap.add_argument("--lon", type=float, default=0.0)
    args = ap.parse_args(argv)
    os.makedirs(args.out_dir, exist_ok=True)
    written = []
    for f in args.files:
        out = extract_location(netcdf.open_dataarray(f), args.lat, args.lon)
        path = os.path.join(args.out_dir,
                            os.path.basename(f).replace(".nc", "_single_location.nc"))
        netcdf.save_dataarray(path, out, var_name="tas")
        written.append(path)
        print(path)
    return written


if __name__ == "__main__":
    main()
