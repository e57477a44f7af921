"""Minimal netCDF4/HDF5 reader and writer built on h5py.

Copy of ``bayesian_ensembling_tpu/io/netcdf.py`` (host code, numpy only):
the bundled GMST files are netCDF4 (= HDF5), so a small reader is all the
loaders need.  Returns :class:`~bayesian_ensembling_tpu_torch.coords.DimArray`
objects with decoded ``datetime64[ns]`` time coordinates.

``h5py`` is imported inside the two functions, so the package imports
without it; calling either without ``h5py`` raises an ``ImportError`` that
names it.
"""

from __future__ import annotations

import typing as tp
import warnings

import numpy as np

from bayesian_ensembling_tpu_torch.coords import DimArray
from bayesian_ensembling_tpu_torch.io import timeutils

__all__ = ["open_dataarray", "save_dataarray"]


def _h5py():
    try:
        import h5py
    except ImportError as e:
        raise ImportError(
            "reading and writing netCDF files needs h5py, which is not installed"
        ) from e
    return h5py


def _is_dim_scale(ds) -> bool:
    return ds.attrs.get("CLASS", b"") == b"DIMENSION_SCALE"


def _main_variable(f, h5py):
    """Pick the (single) data variable: the non-dimension dataset with the
    most dimensions, ignoring bounds variables."""
    best = None
    for name, ds in f.items():
        if not isinstance(ds, h5py.Dataset) or _is_dim_scale(ds):
            continue
        if name.endswith("_bnds") or name.endswith("_bounds"):
            continue
        if best is None or ds.ndim > best[1].ndim:
            best = (name, ds)
    if best is None:
        raise ValueError("no data variable found in file")
    return best


def _dim_names(f, var, h5py) -> tp.Tuple[str, ...]:
    names = []
    if "DIMENSION_LIST" in var.attrs:
        for ax_refs in var.attrs["DIMENSION_LIST"]:
            if len(ax_refs):
                names.append(f[ax_refs[0]].name.lstrip("/"))
            else:
                # Phony axis with no attached scale (some writers): a
                # generated name rather than IndexError.
                names.append(f"dim_{len(names)}")
        return tuple(names)
    # Fall back: match dimension-scale datasets by length, consuming each
    # scale at most once (two equal-length axes must not both claim the
    # same name: duplicate dims would collide in DimArray.coords).
    scales = {n: d for n, d in f.items() if isinstance(d, h5py.Dataset) and _is_dim_scale(d)}
    used: set = set()
    for size in var.shape:
        match = [n for n, d in scales.items() if d.shape == (size,) and n not in used]
        if match:
            if len(match) > 1:
                # Without DIMENSION_LIST, equal-length axes are assigned by
                # file order, possibly transposed (a square lat/lon grid).
                warnings.warn(
                    f"file has no DIMENSION_LIST and several dimension "
                    f"scales of length {size} ({match}); assigning "
                    f"{match[0]!r} by file order — verify axis order"
                )
            names.append(match[0])
            used.add(match[0])
        else:
            names.append(f"dim_{len(names)}")
    return tuple(names)


_GREGORIAN_CALENDARS = {"standard", "gregorian", "proleptic_gregorian", ""}


def _attr_str(attrs, key: str) -> str:
    v = attrs.get(key, b"")
    return v.decode() if isinstance(v, bytes) else str(v)


def open_dataarray(path: str, name: tp.Optional[str] = None) -> DimArray:
    """Read the main variable of a netCDF4 file as a :class:`DimArray`.

    Decodes CF time into ``datetime64[ns]`` (gregorian-family calendars
    only; other CMIP calendars like ``360_day``/``noleap`` raise instead of
    being mis-decoded), unpacks CF ``scale_factor``/``add_offset``, and
    applies ``_FillValue``/``missing_value`` as NaN.
    """
    h5py = _h5py()
    with h5py.File(path, "r") as f:
        var_name, var = _main_variable(f, h5py)
        dims = _dim_names(f, var, h5py)
        values = var[...]
        scale = var.attrs.get("scale_factor")
        offset = var.attrs.get("add_offset")
        fills = [
            np.asarray(var.attrs[k]).ravel()[0]
            for k in ("_FillValue", "missing_value")
            if k in var.attrs
        ]
        if scale is not None or offset is not None or (
            fills and not np.issubdtype(values.dtype, np.floating)
        ):
            # CF packed data: unpack to float BEFORE fill masking so integer
            # fill sentinels can become NaN.
            values = values.astype(np.float64)
        for fv in fills:
            if not (np.issubdtype(type(fv), np.floating) and np.isnan(fv)):
                values = np.where(values == fv, np.nan, values)
        if scale is not None:
            values = values * np.asarray(scale).ravel()[0]
        if offset is not None:
            values = values + np.asarray(offset).ravel()[0]
        coords: tp.Dict[str, np.ndarray] = {}
        for d in dims:
            if d not in f:
                continue
            cv = f[d][...]
            units = _attr_str(f[d].attrs, "units")
            if d == "time" and "since" in units:
                calendar = _attr_str(f[d].attrs, "calendar").lower()
                if calendar not in _GREGORIAN_CALENDARS:
                    raise NotImplementedError(
                        f"time calendar {calendar!r} in {path} is not a "
                        "gregorian-family calendar; decoding it as gregorian "
                        "would silently shift every date"
                    )
                cv = timeutils.decode_cf_time(cv, units)
            elif cv.dtype == object or cv.dtype.kind in "SU":
                cv = np.arange(len(cv))
            coords[d] = cv
    return DimArray(values, dims, coords, name=name or var_name)


_NS_PER_HOUR = 3600 * 10**9


def save_dataarray(path: str, da: DimArray, var_name: tp.Optional[str] = None):
    """Write a DimArray as a netCDF4-flavoured HDF5 file (h5py dimension
    scales; CF time encoded as '<unit> since <epoch>').  Round-trips through
    :func:`open_dataarray`."""
    h5py = _h5py()
    var_name = var_name or da.name or "data"
    with h5py.File(path, "w") as f:
        v = f.create_dataset(var_name, data=np.asarray(da.values))
        for ax, d in enumerate(da.dims):
            coord = da.get_coord(d)
            if d == "time" and np.issubdtype(coord.dtype, np.datetime64):
                epoch = coord[0].astype("datetime64[ns]")
                # decode_cf_time parses epochs at microsecond resolution:
                # align the epoch down to a whole microsecond and let the
                # offsets absorb any sub-microsecond remainder.
                epoch = epoch - (int(epoch.astype("int64")) % 1000) * np.timedelta64(1, "ns")
                offsets_ns = (coord.astype("datetime64[ns]") - epoch).astype("int64")
                # The coarsest CF unit that represents the offsets exactly;
                # float64 seconds for sub-second offsets.
                for unit, div in (("hours", _NS_PER_HOUR), ("seconds", 10**9)):
                    if not np.any(offsets_ns % div):
                        enc = (offsets_ns // div).astype(np.int64)
                        break
                else:
                    unit, enc = "seconds", offsets_ns / 1e9
                ds = f.create_dataset(d, data=enc)
                # The units string carries the exact epoch, fractional
                # seconds included.
                if int(epoch.astype("int64")) % 10**9:
                    epoch_s = np.datetime_as_string(
                        epoch.astype("datetime64[us]"), unit="us"
                    ).replace("T", " ")
                else:
                    epoch_s = np.datetime_as_string(
                        epoch.astype("datetime64[s]"), unit="s"
                    ).replace("T", " ")
                ds.attrs["units"] = np.bytes_(f"{unit} since {epoch_s}")
                ds.attrs["calendar"] = np.bytes_("proleptic_gregorian")
            else:
                ds = f.create_dataset(d, data=np.asarray(coord))
            ds.make_scale(d)
            v.dims[ax].attach_scale(ds)
