"""Presentation helpers: palette, style cycling, distribution plots.

Copy of ``bayesian_ensembling_tpu/plotters.py`` for the port's containers
(``ProcessModel.plot``, ``ModelCollection.plot_all/plot_grid``,
``Posterior.plot_temporally/plot_spatially``).  matplotlib is imported
inside the functions, so the package imports without it; posterior moments
come to the host through the containers' numpy views (``Posterior.mean``
and ``Posterior.stddev``).  Spatial maps draw Robinson-projection cartopy
axes with coastlines when cartopy is importable and fall back to
lat/lon-extent images otherwise.
"""

from __future__ import annotations

import os
import sys
import typing as tp

import numpy as np

__all__ = [
    "pyplot",
    "cmap",
    "get_style_cycler",
    "unique_legend",
    "plot_process_model",
    "plot_collection",
    "plot_collection_grid",
    "plot_posterior_temporal",
    "plot_posterior_spatial",
]

# seaborn 'Set2' palette, hardcoded to avoid a seaborn dependency.
_SET2 = [
    "#66c2a5", "#fc8d62", "#8da0cb", "#e78ac3",
    "#a6d854", "#ffd92f", "#e5c494", "#b3b3b3",
]


def pyplot():
    """``matplotlib.pyplot``, on the Agg backend when no display can work
    and pyplot has not picked a backend yet (a backend already in use is
    kept).  The no-display probe applies to X11/Wayland Linux only."""
    import matplotlib

    headless = (
        sys.platform.startswith("linux")
        and not os.environ.get("DISPLAY")
        and not os.environ.get("WAYLAND_DISPLAY")
    )
    if "matplotlib.pyplot" not in sys.modules and headless:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def cmap() -> tp.List[str]:
    """The library palette (seaborn Set2)."""
    return list(_SET2)


def get_style_cycler():
    """Colour x linestyle cycler, 32 combinations."""
    from cycler import cycler

    linestyles = ["-", "--", ":", "-."]
    return cycler(linestyle=linestyles) * cycler(color=_SET2)


def unique_legend(ax):
    """Deduplicate legend entries."""
    handles, labels = ax.get_legend_handles_labels()
    seen = {}
    for h, l in zip(handles, labels):
        seen.setdefault(l, h)
    ax.legend(seen.values(), seen.keys(), loc="best")
    return ax


def _collapse_to_time(values: np.ndarray, keep_axes: tp.Tuple[int, ...]):
    axes = tuple(a for a in range(values.ndim) if a not in keep_axes)
    return values.mean(axis=axes) if axes else values


def plot_process_model(pm, ax=None):
    """Realisations + mean over time."""
    if ax is None:
        _, ax = pyplot().subplots(figsize=(12, 7))
    vals = pm.data.values
    if vals.ndim > 2:
        vals = vals.reshape(vals.shape[0], vals.shape[1], -1).mean(-1)
    x = pm.time
    for r in range(vals.shape[0]):
        ax.plot(x, vals[r], alpha=0.1, color="gray", label="Realisations", ls="-")
    ax.plot(x, vals.mean(0), label="Model mean", alpha=0.7, color=_SET2[0])
    unique_legend(ax)
    ax.set_title(pm.name)
    return ax


def plot_collection(collection, ax=None, legend=False, one_color=None):
    """All model means on one axes."""
    if ax is None:
        _, ax = pyplot().subplots(figsize=(15, 7))
    ax.set_prop_cycle(get_style_cycler())
    for pm in collection:
        vals = pm.data.values
        if vals.ndim > 2:
            vals = vals.reshape(vals.shape[0], vals.shape[1], -1).mean(-1)
        mean = vals.mean(0)
        if one_color:
            ax.plot(pm.time, mean, alpha=0.3, color=one_color)
        else:
            ax.plot(pm.time, mean, alpha=0.5, label=pm.name)
    if legend:
        ax.legend(loc="best")
    return ax


def plot_collection_grid(collection):
    """One panel per model with realisations."""
    n = len(collection)
    ncols = 3
    nrows = int(np.ceil(n / ncols))
    fig, axes = pyplot().subplots(
        figsize=(15, 4 * nrows), nrows=nrows, ncols=ncols, sharey=True, squeeze=False
    )
    for pm, ax in zip(collection, axes.ravel()):
        plot_process_model(pm, ax=ax)
    return fig


def plot_posterior_temporal(post, ax=None, color=None, label=None, n_sigma=(1, 2, 3)):
    """Mean +- k sigma bands over time, collapsing spatial dims."""
    if ax is None:
        _, ax = pyplot().subplots(figsize=(14, 7))
    color = color or "tab:blue"
    mean = post.mean
    sd = post.stddev
    t = mean.get_coord("time") if "time" in mean.dims else np.arange(mean.shape[0])
    m = _collapse_to_time(mean.values, (mean.dims.index("time"),) if "time" in mean.dims else (0,))
    s = _collapse_to_time(sd.values, (sd.dims.index("time"),) if "time" in sd.dims else (0,))
    for k in sorted(n_sigma, reverse=True):
        ax.fill_between(t, m - k * s, m + k * s, alpha=0.2, color=color, linewidth=0)
    ax.plot(t, m, color=color, zorder=10, label=label)
    return ax


def _geo_projections():
    """(plot_proj, data_proj) when cartopy is importable, else (None, None):
    Robinson-projection map axes with PlateCarree-referenced data, as the
    reference draws its spatial posteriors; cartopy is optional."""
    try:
        import cartopy.crs as ccrs
    except Exception:
        return None, None
    return ccrs.Robinson(), ccrs.PlateCarree()


def plot_posterior_spatial(post, fig=None):
    """Time-mean maps of posterior mean and stddev.

    Uses Robinson-projection map axes with coastlines when cartopy is
    importable; otherwise plain lat/lon-extent images."""
    mean = post.mean
    sd = post.stddev
    dims = mean.dims
    if "latitude" not in dims or "longitude" not in dims:
        raise ValueError("spatial plot needs latitude/longitude dims")
    if "time" in dims:
        t_ax = dims.index("time")
        m = mean.values.mean(axis=t_ax)
        s = sd.values.mean(axis=t_ax)
        rem = tuple(d for d in dims if d != "time")
    else:
        m, s = mean.values, sd.values
        rem = dims
    lat = np.asarray(mean.get_coord("latitude"), float)
    lon = np.asarray(mean.get_coord("longitude"), float)
    # Orient (latitude, longitude) from the dims tuple, not from the shape:
    # a square grid is shape-ambiguous.
    if rem.index("latitude") > rem.index("longitude"):
        m, s = m.T, s.T
    # Both axes ascending, so the imshow fallback's origin/extent stay
    # truthful for descending-latitude products (90..-90).
    if lat.size > 1 and lat[0] > lat[-1]:
        lat, m, s = lat[::-1], m[::-1], s[::-1]
    if lon.size > 1 and lon[0] > lon[-1]:
        lon, m, s = lon[::-1], m[:, ::-1], s[:, ::-1]
    plot_proj, data_proj = _geo_projections()
    if fig is None:
        fig = pyplot().figure(figsize=(12, 5))
    for i, (field, title) in enumerate(zip((m, s), ("mean", "stddev"))):
        if plot_proj is not None:
            ax = fig.add_subplot(1, 2, i + 1, projection=plot_proj)
            im = ax.pcolormesh(lon, lat, field, transform=data_proj, cmap="viridis")
            ax.coastlines()
        else:
            ax = fig.add_subplot(1, 2, i + 1)
            im = ax.imshow(
                field,
                origin="lower",
                aspect="auto",
                cmap="viridis",
                extent=(lon.min(), lon.max(), lat.min(), lat.max()),
            )
            ax.set_xlabel("longitude")
            ax.set_ylabel("latitude")
        fig.colorbar(im, ax=ax, orientation="horizontal")
        ax.set_title(f"posterior {title}")
    return fig
