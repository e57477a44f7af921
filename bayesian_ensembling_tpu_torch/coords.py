"""Lightweight labelled-dimension arrays.

Copy of ``bayesian_ensembling_tpu/coords.py`` (numpy only).  The reference
library leans on ``xarray.DataArray`` for coordinate bookkeeping
(``ensembles/data.py``); :class:`DimArray` is a small, dependency-free
replacement that carries a numpy array together with a tuple of dimension
names and optional per-dimension coordinate vectors.

Design notes:
  * the payload stays a plain host array; anything hot is handed to the
    tensor functions as raw arrays, ``DimArray`` only does bookkeeping.
  * binary ops align operands by dimension *name* (xarray-style broadcasting),
    which is what the reference relies on when multiplying weights with means.
  * time coordinates are ``numpy.datetime64[ns]`` vectors; climatology /
    resampling helpers live in :mod:`bayesian_ensembling_tpu_torch.io.timeutils`.
"""

from __future__ import annotations

import dataclasses
import typing as tp

import numpy as np

__all__ = ["DimArray"]


def _as_host(values) -> np.ndarray:
    """Materialise any array-like as numpy on the host."""
    return np.asarray(values)


@dataclasses.dataclass
class DimArray:
    """An n-dimensional array with named dimensions and optional coordinates.

    Mirrors the subset of ``xarray.DataArray`` behaviour the reference uses
    (``data.py``, ``weights.py``): named-dim reductions, name-aligned
    arithmetic broadcasting, integer/label selection and simple metadata.
    """

    values: np.ndarray
    dims: tp.Tuple[str, ...]
    coords: tp.Dict[str, np.ndarray] = dataclasses.field(default_factory=dict)
    name: tp.Optional[str] = None

    def __post_init__(self):
        self.values = _as_host(self.values)
        self.dims = tuple(self.dims)
        if self.values.ndim != len(self.dims):
            raise ValueError(
                f"values has {self.values.ndim} dims but names {self.dims}"
            )
        clean = {}
        for k, v in self.coords.items():
            if k not in self.dims:
                raise ValueError(f"coordinate {k!r} not in dims {self.dims}")
            v = np.asarray(v)
            ax = self.dims.index(k)
            if v.shape != (self.values.shape[ax],):
                raise ValueError(
                    f"coordinate {k!r} has shape {v.shape}, expected "
                    f"({self.values.shape[ax]},)"
                )
            clean[k] = v
        self.coords = clean

    # ------------------------------------------------------------------ basic
    @property
    def shape(self) -> tp.Tuple[int, ...]:
        return self.values.shape

    @property
    def ndim(self) -> int:
        return self.values.ndim

    @property
    def size(self) -> int:
        return self.values.size

    @property
    def dtype(self):
        return self.values.dtype

    def sizes(self) -> tp.Dict[str, int]:
        return dict(zip(self.dims, self.values.shape))

    def axis_of(self, dim: str) -> int:
        try:
            return self.dims.index(dim)
        except ValueError:
            raise KeyError(f"dimension {dim!r} not found in {self.dims}") from None

    def get_coord(self, dim: str) -> np.ndarray:
        if dim in self.coords:
            return self.coords[dim]
        return np.arange(self.sizes()[dim])

    @property
    def time(self) -> np.ndarray:
        return self.get_coord("time")

    def copy(self, values: tp.Optional[np.ndarray] = None) -> "DimArray":
        return DimArray(
            values=self.values.copy() if values is None else _as_host(values),
            dims=self.dims,
            coords={k: v.copy() for k, v in self.coords.items()},
            name=self.name,
        )

    def rename(self, name: str) -> "DimArray":
        out = self.copy()
        out.name = name
        return out

    # -------------------------------------------------------------- selection
    def isel(self, **indexers) -> "DimArray":
        """Integer/slice selection along named dims (like ``xarray.isel``).

        Array indexers on several dims select OUTER products (xarray
        semantics), not numpy's broadcast/diagonal indexing — each dim is
        indexed independently.
        """
        dropped = set()
        values = self.values
        # Apply one dim at a time (np.take) so multiple array indexers give
        # the xarray outer selection instead of numpy fancy indexing.
        for dim, sel in indexers.items():
            ax = self.axis_of(dim)
            if np.isscalar(sel) or (isinstance(sel, np.ndarray) and sel.ndim == 0):
                dropped.add(dim)
            index: tp.List[tp.Any] = [slice(None)] * values.ndim
            # Axis positions shift as scalar-selected dims collapse; recompute
            # against the dims not yet dropped in earlier iterations.
            live_dims = [d for d in self.dims if d not in dropped or d == dim]
            index[live_dims.index(dim)] = sel
            values = values[tuple(index)]
        new_dims = tuple(d for d in self.dims if d not in dropped)
        new_coords = {}
        for k, v in self.coords.items():
            if k in dropped:
                continue
            sel = indexers.get(k, slice(None))
            new_coords[k] = v[sel]
        return DimArray(values, new_dims, new_coords, self.name)

    def sel_time(self, start=None, stop=None) -> "DimArray":
        """Select a closed time interval [start, stop] (like ``.sel(time=slice())``)."""
        t = self.time
        lo = t >= np.datetime64(start) if start is not None else np.ones_like(t, bool)
        hi = t <= np.datetime64(stop) if stop is not None else np.ones_like(t, bool)
        idx = np.nonzero(lo & hi)[0]
        return self.isel(time=idx)

    # ------------------------------------------------------------- reductions
    def _reduce(self, fn, dim=None, **kw) -> "DimArray":
        if dim is None:
            return fn(self.values, **kw)
        dims = (dim,) if isinstance(dim, str) else tuple(dim)
        axes = tuple(self.axis_of(d) for d in dims)
        values = fn(self.values, axis=axes, **kw)
        new_dims = tuple(d for d in self.dims if d not in dims)
        new_coords = {k: v for k, v in self.coords.items() if k not in dims}
        return DimArray(values, new_dims, new_coords, self.name)

    def mean(self, dim=None):
        return self._reduce(np.mean, dim)

    def std(self, dim=None, ddof: int = 0):
        return self._reduce(np.std, dim, ddof=ddof)

    def var(self, dim=None, ddof: int = 0):
        return self._reduce(np.var, dim, ddof=ddof)

    def min(self, dim=None):
        return self._reduce(np.min, dim)

    def max(self, dim=None):
        return self._reduce(np.max, dim)

    def sum(self, dim=None):
        return self._reduce(np.sum, dim)

    # ------------------------------------------------------------ arithmetic
    def _binary(self, other, op) -> "DimArray":
        if isinstance(other, DimArray):
            out_dims = list(self.dims) + [d for d in other.dims if d not in self.dims]
            a = self._expand_to(out_dims)
            b = other._expand_to(out_dims)
            coords = dict(other.coords)
            coords.update(self.coords)
            coords = {k: v for k, v in coords.items() if k in out_dims}
            return DimArray(op(a, b), tuple(out_dims), coords, self.name)
        return DimArray(op(self.values, other), self.dims, self.coords, self.name)

    def _expand_to(self, out_dims: tp.Sequence[str]) -> np.ndarray:
        """Reshape/transpose values so axes line up with ``out_dims``."""
        missing = [d for d in out_dims if d not in self.dims]
        vals = self.values.reshape(self.values.shape + (1,) * len(missing))
        cur = list(self.dims) + missing
        perm = [cur.index(d) for d in out_dims]
        return np.transpose(vals, perm)

    def __add__(self, o):
        return self._binary(o, np.add)

    def __radd__(self, o):
        return self._binary(o, lambda a, b: np.add(b, a))

    def __sub__(self, o):
        return self._binary(o, np.subtract)

    def __rsub__(self, o):
        return self._binary(o, lambda a, b: np.subtract(b, a))

    def __mul__(self, o):
        return self._binary(o, np.multiply)

    def __rmul__(self, o):
        return self._binary(o, lambda a, b: np.multiply(b, a))

    def __truediv__(self, o):
        return self._binary(o, np.divide)

    def __rtruediv__(self, o):
        return self._binary(o, lambda a, b: np.divide(b, a))

    def __pow__(self, o):
        return self._binary(o, np.power)

    def __neg__(self):
        return DimArray(-self.values, self.dims, self.coords, self.name)

    # --------------------------------------------------------------- reshape
    def expand_dims(self, dim: str, size: int = 1, coord=None, axis: int = 0) -> "DimArray":
        """Insert a new (broadcast) dimension, like ``xarray.expand_dims``."""
        values = np.expand_dims(self.values, axis)
        values = np.broadcast_to(
            values, values.shape[:axis] + (size,) + values.shape[axis + 1 :]
        ).copy()
        dims = self.dims[:axis] + (dim,) + self.dims[axis:]
        coords = dict(self.coords)
        if coord is not None:
            coords[dim] = np.asarray(coord)
        return DimArray(values, dims, coords, self.name)

    def transpose(self, *order: str) -> "DimArray":
        perm = [self.axis_of(d) for d in order]
        return DimArray(
            np.transpose(self.values, perm), tuple(order), dict(self.coords), self.name
        )

    def stack_with(self, others: tp.Sequence["DimArray"], dim: str, coord=None) -> "DimArray":
        """Concatenate self + others along a brand-new leading dim."""
        arrs = [self] + list(others)
        values = np.stack([a.values for a in arrs], axis=0)
        dims = (dim,) + self.dims
        coords = dict(self.coords)
        if coord is not None:
            coords[dim] = np.asarray(coord)
        return DimArray(values, dims, coords, self.name)

    def __repr__(self) -> str:  # pragma: no cover - debug helper
        dims = ", ".join(f"{d}: {s}" for d, s in self.sizes().items())
        return f"<DimArray {self.name or ''} ({dims}) dtype={self.dtype}>"


def concat(arrays: tp.Sequence[DimArray], dim: str, coord=None) -> DimArray:
    """Concatenate arrays along a new leading dimension ``dim``."""
    return arrays[0].stack_with(arrays[1:], dim, coord=coord)
