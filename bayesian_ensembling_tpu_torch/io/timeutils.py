"""Calendar helpers: CF time decoding, monthly climatology, annual resampling.

Replaces the xarray/pandas machinery the reference uses for
``groupby("time.month")`` climatologies and ``resample(time='Y')``
(``ensembles/data.py:225-261``).  All of this is cheap host
preprocessing done once per dataset, so plain numpy is the right tool; the
results feed device arrays.
"""

from __future__ import annotations

import re
import typing as tp

import numpy as np

__all__ = [
    "decode_cf_time",
    "months_of",
    "years_of",
    "monthly_climatology",
    "apply_climatology",
    "annual_mean",
    "resample_mean",
]

_UNIT_NS = {
    "microseconds": np.timedelta64(1, "us").astype("timedelta64[ns]"),
    "milliseconds": np.timedelta64(1, "ms").astype("timedelta64[ns]"),
    "seconds": np.timedelta64(1, "s").astype("timedelta64[ns]"),
    "minutes": np.timedelta64(1, "m").astype("timedelta64[ns]"),
    "hours": np.timedelta64(1, "h").astype("timedelta64[ns]"),
    "days": np.timedelta64(1, "D").astype("timedelta64[ns]"),
}
# udunits singular/abbreviated spellings accepted by CF writers in the wild.
_UNIT_ALIASES = {
    "microsecond": "microseconds",
    "usecs": "microseconds",
    "usec": "microseconds",
    "millisecond": "milliseconds",
    "msecs": "milliseconds",
    "msec": "milliseconds",
    "ms": "milliseconds",
    "second": "seconds",
    "secs": "seconds",
    "sec": "seconds",
    "s": "seconds",
    "minute": "minutes",
    "mins": "minutes",
    "min": "minutes",
    "hour": "hours",
    "hrs": "hours",
    "hr": "hours",
    "h": "hours",
    "day": "days",
    "d": "days",
}


def decode_cf_time(values: np.ndarray, units: str) -> np.ndarray:
    """Decode CF-convention numeric time to ``datetime64[ns]``.

    Supports '<unit> since <timestamp>' for microseconds through days
    (plus the udunits singular/abbreviated spellings) and
    gregorian/proleptic_gregorian/standard calendars (all the bundled GMST
    files use these; verified by h5py inspection of
    ``experiments/data/*`` — e.g. 'days since 1850-01-01' for HadCRUT5 and
    'hours since 1850-01-16 12:00:00' for CMIP6 members).
    """
    m = re.match(r"\s*(\w+)\s+since\s+(.+?)\s*$", units)
    if not m:
        raise ValueError(f"cannot parse CF time units: {units!r}")
    unit, epoch_str = m.group(1).lower(), m.group(2)
    unit = _UNIT_ALIASES.get(unit, unit)
    if unit not in _UNIT_NS:
        raise ValueError(f"unsupported CF time unit {unit!r}")
    epoch_str = epoch_str.replace(" ", "T").split("T")
    date = epoch_str[0]
    time = epoch_str[1] if len(epoch_str) > 1 else "00:00:00"
    # Parse the epoch at MICROSECOND resolution: datetime64[ns] only spans
    # 1677-2262 and np.datetime64(..., "ns") silently WRAPS outside it
    # (e.g. 'days since 0001-01-01' became 1754), while the offset multiply
    # could overflow int64 ns to NaT with only a RuntimeWarning.  Compute
    # wide, check the DECODED range, fail loudly instead of corrupting.
    epoch = np.datetime64(f"{date}T{time}", "us")
    vals = np.asarray(values, dtype=np.float64)
    step_us = _UNIT_NS[unit].astype(np.int64) // 1000
    off_us_f = vals * step_us
    if vals.size and (
        not np.isfinite(off_us_f).all()
        or np.abs(off_us_f).max() >= float(2**62)
    ):
        raise ValueError(f"CF time offsets overflow for units {units!r}")
    off_us = np.round(off_us_f).astype(np.int64)
    # Sub-microsecond residual keeps small offsets ns-exact (float64 only
    # carries ns resolution for offsets below ~0.1 day anyway).
    res_ns = np.round((off_us_f - off_us) * 1000.0).astype(np.int64)
    out_us = epoch + off_us.astype("timedelta64[us]")
    lo = np.datetime64("1677-09-22T00:00:00", "us")
    hi = np.datetime64("2262-04-10T23:59:59", "us")
    if vals.size and (out_us.min() < lo or out_us.max() > hi):
        raise ValueError(
            f"decoded times [{out_us.min()}, {out_us.max()}] fall outside "
            f"the datetime64[ns] range (1678-2262) for units {units!r}"
        )
    return out_us.astype("datetime64[ns]") + res_ns.astype("timedelta64[ns]")


def months_of(time: np.ndarray) -> np.ndarray:
    """Month number (1-12) for each datetime64."""
    t = time.astype("datetime64[M]")
    return (t.astype(int) % 12) + 1


def years_of(time: np.ndarray) -> np.ndarray:
    """Calendar year for each datetime64."""
    return time.astype("datetime64[Y]").astype(int) + 1970


def monthly_climatology(
    data: np.ndarray,
    time: np.ndarray,
    window: tp.Tuple[str, str] = ("1961-01-01", "1990-12-31"),
) -> np.ndarray:
    """Per-month climatology averaged over realisations and window years.

    Equivalent to ``da.sel(time=slice(*window)).groupby("time.month").mean()
    .mean("realisation")`` (data.py:246-247) — including xarray's
    NaN-skipping mean semantics (missing cells reduce the sample count
    instead of poisoning the whole month).

    Args:
      data: ``(realisation, time, *space)`` array.
      time: ``(time,)`` datetime64 vector.
      window: inclusive [start, end] of the climatological period.

    Returns:
      ``(12, *space)`` climatology (month index 0 = January).
    """
    lo, hi = np.datetime64(window[0]), np.datetime64(window[1])
    if "T" in str(window[1]) or ":" in str(window[1]):
        # Timestamped end: inclusive of that exact instant.
        in_win = (time >= lo) & (time <= hi)
    else:
        # Label end: include the WHOLE labelled period at the string's own
        # resolution, like xarray's sel(time=slice(a, b)) — '1990-12-31'
        # covers the full day, '1990-12' the full month, '1990' the full
        # year.  np.datetime64 parses each at its native unit, so +1 steps
        # exactly one such period; comparing <= the parsed instant silently
        # dropped every later stamp inside the period (e.g. mid-month CMIP
        # monthly stamps against a '1990-12' end).
        hi_excl = (hi + 1).astype("datetime64[ns]")
        in_win = (time >= lo) & (time < hi_excl)
    months = months_of(time)
    out_shape = (12,) + data.shape[2:]
    clim = np.empty(out_shape, dtype=data.dtype)
    for m in range(1, 13):
        sel = in_win & (months == m)
        if not sel.any():
            raise ValueError(f"no samples for month {m} in climatology window")
        clim[m - 1] = np.nanmean(data[:, sel], axis=(0, 1))
    return clim


def apply_climatology(data: np.ndarray, time: np.ndarray, clim: np.ndarray) -> np.ndarray:
    """Subtract the per-month climatology: ``da.groupby('time.month') - clim``."""
    months = months_of(time)
    return data - clim[months - 1]


def annual_mean(data: np.ndarray, time: np.ndarray, time_axis: int = 1):
    """Yearly mean along the time axis (``resample(time='Y').mean()``)."""
    return resample_mean(data, time, "Y", time_axis=time_axis)


# pandas-style frequency aliases -> (canonical period kind, start-anchored?)
# End-anchored aliases (M/ME, Q/QE, Y/YE/A) label period ENDS; the
# start-anchored spellings (MS, QS, YS/AS) label period STARTS, matching
# pandas' resample label conventions.  Values are identical either way.
_FREQ_ALIASES = {
    "M": ("M", False), "ME": ("M", False), "1M": ("M", False),
    "MS": ("M", True),
    "Q": ("Q", False), "QE": ("Q", False), "1Q": ("Q", False),
    "QS": ("Q", True),
    "Y": ("Y", False), "YE": ("Y", False), "A": ("Y", False),
    "1Y": ("Y", False),
    "AS": ("Y", True), "YS": ("Y", True),
}


def _month_end(year: int, month: int) -> np.datetime64:
    """Last day of (year, month) as datetime64[ns]."""
    m0 = np.datetime64(f"{year}-{month:02d}", "M")
    return (m0 + 1).astype("datetime64[D]") - np.timedelta64(1, "D")


def resample_mean(
    data: np.ndarray, time: np.ndarray, freq: str, time_axis: int = 1
):
    """Downsample-by-mean along the time axis at a pandas-style frequency.

    Capability match for the reference's arbitrary ``resample(time=freq)``
    (``ensembles/data.py:255-257``) for the calendar
    frequencies climate workflows use: monthly ('M'/'ME'), quarterly
    ('Q'/'QE', calendar quarters Jan-Mar...), annual ('Y'/'YE'/'A').  Labels
    are period-end dates, matching pandas' end-anchored conventions.

    Returns (resampled_data, new_time); groups appear in chronological order.
    """
    kind_anchor = _FREQ_ALIASES.get(str(freq).upper())
    if kind_anchor is None:
        raise NotImplementedError(
            f"resample_freq={freq!r} unsupported; use one of "
            f"{sorted(set(_FREQ_ALIASES))}"
        )
    kind, start_anchored = kind_anchor
    years = years_of(time)
    months = months_of(time)
    if kind == "M":
        keys = years * 12 + (months - 1)
        if start_anchored:
            label = lambda k: np.datetime64(f"{k // 12}-{k % 12 + 1:02d}-01", "D")
        else:
            label = lambda k: _month_end(k // 12, k % 12 + 1)
    elif kind == "Q":
        keys = years * 4 + (months - 1) // 3
        if start_anchored:
            label = lambda k: np.datetime64(
                f"{k // 4}-{(k % 4) * 3 + 1:02d}-01", "D"
            )
        else:
            label = lambda k: _month_end(k // 4, (k % 4) * 3 + 3)
    else:  # Y
        keys = years
        if start_anchored:
            label = lambda k: np.datetime64(f"{k}-01-01", "D")
        else:
            label = lambda k: np.datetime64(f"{k}-12-31", "D")
    uniq = np.unique(keys)
    # nanmean matches xarray's resample().mean() NaN-skipping semantics.
    pieces = [
        np.nanmean(
            np.take(data, np.nonzero(keys == k)[0], axis=time_axis),
            axis=time_axis,
        )
        for k in uniq
    ]
    out = np.stack(pieces, axis=time_axis)
    new_time = np.array([label(int(k)) for k in uniq], dtype="datetime64[ns]")
    return out, new_time
