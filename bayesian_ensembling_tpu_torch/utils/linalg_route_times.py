"""Time the fit's NLML on the blocked and the library route on the card,
over batch and length: the table that ``linalg_cuda.linalg_path``'s
blocked-route gates (``BLOCKED_MIN_BATCH``, ``BLOCKED_T_CAP``) are set from.

Run from the repository root on a machine with an NVIDIA GPU and nvcc::

    python3 -m bayesian_ensembling_tpu_torch.utils.linalg_route_times [--batches 28 65] [--sizes 1032 1980] [--reps 5] [--no-fit] [--json OUT]

For every (B, T), float32, TF32 off: Matern-3/2 Grams of the fit's form
(features of ``R`` realisations a time step, lengthscale and variance 1,
known noise and jitter on the diagonal) and one NLML value and gradient
with respect to K, as a fit step takes it from its route: through
``linalg_blocked.nlml_terms_blocked`` (blocked) and through
``linalg_cuda.nlml_terms`` beyond the kernels' cap (library,
``torch.linalg``).  Each is timed with CUDA events, eagerly and as replays
of one captured CUDA graph, in turns (blocked, library, library, blocked),
with the peak allocated device memory of one eager call above its inputs.
Then, unless ``--no-fit``, the fit's whole Adam step on each route
(``ops/gp._build_batch_step`` with the route given, run by
``ops/gp._adam_graphed`` as a fit segment runs it), timed as the difference
of two segments' lengths over their difference in replays, with the peak
allocated memory of the longer segment above its inputs.  The last line
of the output is the table as JSON (also written to ``--json``).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import warnings

import torch

from bayesian_ensembling_tpu_torch.ops import gp as gp_ops
from bayesian_ensembling_tpu_torch.ops import linalg_blocked as lb
from bayesian_ensembling_tpu_torch.ops import linalg_cuda as lc
from bayesian_ensembling_tpu_torch.utils.linalg_kernel_times import cuda_ms

BATCHES = (4, 8, 16, 28, 65, 112)
# 240: the first T past the kernels' float32 cap; 1032 / 1980: the monthly
# campaign's SSP and historical fits; 3012: 1850-2100 monthly.
SIZES = (240, 512, 1032, 1536, 1980, 2400, 3012)
REALISATIONS = 8
ROUTES = {"blocked": lb.nlml_terms_blocked, "library": lc.nlml_terms}


def inputs(b, t, dev):
    """``(x (B, T, R), y (B, T), noise (B, T), ky (B, T, T))`` in float32:
    a trend with noisy realisations as features, as ``prepare_gp_inputs``
    forms them, and the Gram at the scratch initialisation."""
    g = torch.Generator(device=dev).manual_seed(0)
    trend = torch.linspace(0.0, 2.5, t, device=dev)
    x = trend[None, :, None] + 0.15 * torch.randn((b, t, REALISATIONS), generator=g, device=dev)
    y = x.mean(-1)
    noise = 0.01 + 0.04 * torch.rand((b, t), generator=g, device=dev)
    pre, apply_fn = gp_ops.get_kernel_precomputed("matern32")
    with torch.no_grad():
        k = apply_fn(gp_ops.init_params(b, device=dev, dtype=torch.float32), pre(x, x))
        ky = (k + torch.diag_embed(noise) + 1e-6 * torch.eye(t, device=dev)).contiguous()
    return x, y, noise, ky


def value_and_grad(nlml, ky, y):
    """One NLML value and its gradient with respect to K."""
    k = ky.detach().requires_grad_(True)
    quad, logdet = nlml(k, y)
    (g,) = torch.autograd.grad((quad + logdet).sum(), (k,))
    return quad.detach(), logdet.detach(), g


def graphed(fn):
    """``fn`` captured once as a CUDA graph (warmed on the capture's side
    stream first); returns the graph's replay."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return graph


def peak_gib(fn):
    """Peak allocated device memory of one ``fn`` call above what was
    allocated before it, GiB."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 2**30


def nlml_row(b, t, dev, reps):
    """Eager and graphed ms and peak GiB of one NLML value and gradient on
    each route at (B, T)."""
    _, y, _, ky = inputs(b, t, dev)
    calls = {r: (lambda fn=fn: value_and_grad(fn, ky, y)) for r, fn in ROUTES.items()}
    row = {}
    for r, call in calls.items():
        row[f"{r}_peak_gib"] = peak_gib(call)
    turns = ("blocked", "library", "library", "blocked")
    eager = [cuda_ms(calls[r], reps) for r in turns]
    graphs = {r: graphed(calls[r]) for r in calls}
    replay = [cuda_ms(graphs[r].replay, reps) for r in turns]
    for r in calls:
        row[f"{r}_ms"] = sum(ms for ms, rr in zip(eager, turns) if rr == r) / 2
        row[f"{r}_graph_ms"] = sum(ms for ms, rr in zip(replay, turns) if rr == r) / 2
    del graphs
    return row


def fit_row(b, t, dev, reps):
    """ms of one replayed Adam step of the fit and the segment's peak GiB
    on each route at (B, T); None where the segment ran out of memory.
    ``reps`` replays set the difference between the two segments."""
    x, y, noise, ky = inputs(b, t, dev)
    del ky
    row = {}
    short = gp_ops.GRAPH_WARMUP_STEPS + 2
    for r in ROUTES:
        try:
            row.update(_fit_segments(x, y, noise, r, dev, short, reps))
        except torch.OutOfMemoryError:
            row.update({f"{r}_fit_ms": None, f"{r}_fit_peak_gib": None, f"{r}_fit_finite": None})
        gp_ops._capture_resources.pop(dev, None)
        torch.cuda.empty_cache()
    return row


def _fit_segments(x, y, noise, r, dev, short, reps):
    b, row = x.shape[0], {}
    step = gp_ops._build_batch_step(x, y, noise, "matern32", 1e-6, "adam", r)
    walls = {}
    for n in (short, short + reps):
        params = gp_ops.init_params(b, device=dev, dtype=torch.float32)
        opt = gp_ops._make_batch_opt("adam", 0.01, params)
        losses = torch.empty((n, b), device=dev)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        gp_ops._adam_graphed(step, params, opt, losses)
        end.record()
        end.synchronize()
        walls[n] = start.elapsed_time(end)
        row[f"{r}_fit_peak_gib"] = (torch.cuda.max_memory_allocated() - base) / 2**30
        row[f"{r}_fit_finite"] = bool(torch.isfinite(losses).all())
    row[f"{r}_fit_ms"] = (walls[short + reps] - walls[short]) / reps
    return row


def _num(v):
    return "out of memory" if v is None else f"{v:.3f}"


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--batches", type=int, nargs="+", default=list(BATCHES))
    parser.add_argument("--sizes", type=int, nargs="+", default=list(SIZES))
    parser.add_argument("--reps", type=int, default=5, help="calls per timing turn")
    parser.add_argument("--no-fit", action="store_true", help="time the NLML alone")
    parser.add_argument("--json", help="also write the table here")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda", torch.cuda.current_device())
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"{card}; allow_tf32 {torch.backends.cuda.matmul.allow_tf32}; gates now: blocked for "
          f"B >= {lc.BLOCKED_MIN_BATCH}, T <= {lc.BLOCKED_T_CAP}", flush=True)
    warnings.filterwarnings("ignore", message="batched linalg")
    table = []
    for t in args.sizes:
        for b in args.batches:
            row = dict(b=b, t=t, route=lc.linalg_path(t, b=b), **nlml_row(b, t, dev, args.reps))
            if not args.no_fit:
                # Enough replays for about a second of them: a capture's host
                # time varies by milliseconds.
                n = min(400, max(args.reps, round(1000.0 / row["library_graph_ms"])))
                row.update(fit_row(b, t, dev, n))
            table.append(row)
            print(f"B={b} T={t} ({row['route']} now): NLML value and gradient blocked "
                  f"{row['blocked_ms']:.3f} / library {row['library_ms']:.3f} ms "
                  f"({row['library_ms'] / row['blocked_ms']:.2f}x), graphed "
                  f"{row['blocked_graph_ms']:.3f} / {row['library_graph_ms']:.3f} ms, peak "
                  f"{row['blocked_peak_gib']:.3f} / {row['library_peak_gib']:.3f} GiB"
                  + ("" if args.no_fit else
                     f"; Adam step {_num(row['blocked_fit_ms'])} / {_num(row['library_fit_ms'])} ms, "
                     f"segment peak {_num(row['blocked_fit_peak_gib'])} / "
                     f"{_num(row['library_fit_peak_gib'])} GiB, finite "
                     f"{row['blocked_fit_finite']} / {row['library_fit_finite']}"), flush=True)
            torch.cuda.empty_cache()
    if args.json:
        with open(args.json, "w") as f:
            json.dump(dict(card=card, table=table), f, indent=1)
    print(json.dumps(dict(card=card, table=table)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
