"""Check and time the Cholesky, Cholesky-solve, triangular-inverse and
vector-solve kernels on the card, beside the PyTorch call for the same
function.

Run from the repository root on a machine with an NVIDIA GPU and nvcc::

    python3 -m bayesian_ensembling_tpu_torch.utils.linalg_kernel_times [--reps 200] [--only solve_vec]

It builds the kernels, prints what ptxas reports for the three (registers,
spills, shared memory), holds each kernel against its plain version over a
grid of sizes (T = 1 .. the shared-memory caps, B = 1, 16, 200; float32
within 1e-3 and float64 within 1e-10 of the largest entry; a non-positive
pivot in the first, a middle and the last panel), and then times kernel and
library call at the shapes the paths launch them at, in turns (kernel,
library, library, kernel) with CUDA events; beside each kernel's time stands
its time inside a CUDA graph of 20 launches, where the host's launch rate
(about 0.02 ms a call through the wrapper) no longer shows.  ``--sweep``
adds the kernels'
times over T at B = 16, from which the cost of one more panel can be read.
``--only solve_vec`` checks and times the vector solve alone instead: full
and forward-only (z and logdet bit for bit the full launch's), both layouts
at the resident shapes, beside two ``solve_triangular`` calls, through the
wrapper and in a CUDA graph, with the bytes a block streams a second.
Exits non-zero if a check fails.
"""

from __future__ import annotations

import argparse
import subprocess
import sys

import numpy as np
import torch

from bayesian_ensembling_tpu_torch import _build
from bayesian_ensembling_tpu_torch.ops import linalg_cuda as lc

SIZES = (1, 2, 31, 32, 33, 64, 86, 128, 165)
BATCHES = (1, 16, 200)
TOL = {torch.float32: 1e-3, torch.float64: 1e-10}
# (B, T): the annual step's two collections, the blocked NLML's leaves, one
# library-API scenario's two collections.
SHAPES = ((112, 165), (112, 86), (65, 128), (16, 165), (16, 86))


def make_spd(rng, b, t):
    """Matern-3/2 Grams on sorted 1-D inputs plus noise, as the GP fit sees."""
    x = np.sort(rng.normal(size=(b, t)), axis=1)
    d = np.abs(x[:, :, None] - x[:, None, :]) / 1.3
    k = (1.0 + np.sqrt(3.0) * d) * np.exp(-np.sqrt(3.0) * d)
    return k + rng.uniform(0.05, 0.2, size=(b, t))[:, :, None] * np.eye(t)


def rel(got, want):
    got, want = got.double(), want.double()
    return ((got - want).abs().max() / want.abs().max().clamp(min=1.0)).item()


def cuda_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps, launches=20):
    """Mean device time of one ``fn`` call inside a replayed CUDA graph."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    return cuda_ms(graph.replay, max(1, reps // launches)) / launches


def in_turns(kernel, library, reps):
    """(kernel ms, library ms), each the mean of its two turns."""
    k1, l1, l2, k2 = (cuda_ms(f, reps) for f in (kernel, library, library, kernel))
    return (k1 + k2) / 2, (l1 + l2) / 2


def check(dev):
    ok = True
    worst = {}
    for dtype in (torch.float32, torch.float64):
        cap = lc.KERNEL_T_CAP[dtype]
        for t in SIZES + (cap,):
            for b in BATCHES:
                rng = np.random.default_rng(t * 1000 + b)
                k = torch.from_numpy(make_spd(rng, b, t)).to(dev, dtype)
                y = torch.from_numpy(rng.normal(size=(b, t))).to(dev, dtype)
                want = lc.chol_solve_reference(k, y)
                l = want[0].contiguous()
                errs = {
                    "chol": rel(lc.chol(k), l),
                    "chol_solve": max(rel(g, w) for g, w in zip(lc.chol_solve(k, y), want)),
                    "tri_inv": rel(lc.tri_inv(l), lc.tri_inv_reference(l)),
                }
                torch.cuda.synchronize()
                for name, err in errs.items():
                    key = (name, dtype)
                    worst[key] = max(worst.get(key, 0.0), err)
                    if not err < TOL[dtype]:
                        ok = False
                        print(f"  FAIL {name} {dtype} B={b} T={t}: rel err {err:.3e}")
    for (name, dtype), err in worst.items():
        print(f"  {name} {str(dtype)[6:]}: worst rel err {err:.2e} over T in {SIZES} + cap, B in {BATCHES}")

    for t, column in ((86, 5), (86, 40), (86, 85), (165, 0), (165, 100), (165, 164)):
        rng = np.random.default_rng(column)
        k = make_spd(rng, 3, t)
        k[1, column, column] = -1.0
        k = torch.from_numpy(k).to(dev, torch.float32)
        y = torch.from_numpy(rng.normal(size=(3, t))).to(dev, torch.float32)
        l = lc.chol(k)
        l2, z, alpha, logdet = lc.chol_solve(k, y)
        torch.cuda.synchronize()
        low = torch.tril(torch.ones((t, t), dtype=torch.bool, device=dev))
        from_col = low & (torch.arange(t, device=dev)[None, :] >= column)
        good = all([
            torch.isnan(l[1][from_col]).all(), torch.isfinite(l[1][low & ~from_col]).all(),
            torch.equal(torch.isnan(l), torch.isnan(l2)),
            torch.isnan(z[1, column:]).all(), torch.isfinite(z[1, :column]).all(),
            torch.isnan(alpha[1]).all(), torch.isnan(logdet[1]),
            all(torch.isfinite(o[[0, 2]]).all() for o in (l, l2, z, alpha, logdet)),
        ])
        print(f"  non-positive pivot at column {column} of T={t}: NaN from there on, there only: {good}")
        ok &= bool(good)
    return ok


def times(dev, reps):
    for dtype in (torch.float32, torch.float64):
        for b, t in SHAPES:
            rng = np.random.default_rng(b * t)
            k = torch.from_numpy(make_spd(rng, b, t)).to(dev, dtype)
            y = torch.from_numpy(rng.normal(size=(b, t))).to(dev, dtype)
            l = lc.chol_reference(k).contiguous()
            eye = torch.eye(t, dtype=dtype, device=dev).expand_as(l)
            chol = in_turns(lambda: lc.chol(k), lambda: torch.linalg.cholesky_ex(k), reps)
            inv = in_turns(lambda: lc.tri_inv(l),
                           lambda: torch.linalg.solve_triangular(l, eye, upper=False), reps)
            fused = cuda_ms(lambda: lc.chol_solve(k, y), reps)
            graphed = [graph_ms(f, reps) for f in (lambda: lc.chol(k), lambda: lc.tri_inv(l),
                                                   lambda: lc.chol_solve(k, y))]
            print(f"  B={b} T={t} {str(dtype)[6:]}: chol {chol[0]:.4f} ms (cholesky_ex {chol[1]:.4f}); "
                  f"tri_inv {inv[0]:.4f} ms (solve_triangular {inv[1]:.4f}); chol_solve {fused:.4f} ms; "
                  f"in a CUDA graph: chol {graphed[0]:.4f}, tri_inv {graphed[1]:.4f}, "
                  f"chol_solve {graphed[2]:.4f} ms")


# (B, T) of the vector solve: one library scenario's two collections, the
# B = 1 of FullCovGaussian.log_prob, the annual batch, the monthly batches,
# and one block streaming alone.
SOLVE_VEC_SHAPES = ((16, 165), (16, 86), (1, 165), (112, 165), (65, 1032), (28, 1980), (1, 1980))


def solve_vec_times(dev, reps):
    """The vector solve against its plain version (the forward-only launch's
    z and logdet bit for bit against the full launch's), timed beside two
    solve_triangular calls, through the wrapper and in a CUDA graph; at the
    resident layout's shapes the streamed layout too."""
    ok = True
    caps = dict(lc.SOLVE_VEC_RESIDENT_T_CAP)
    for dtype in (torch.float32, torch.float64):
        for b, t in SOLVE_VEC_SHAPES:
            rng = np.random.default_rng(b * t)
            l = lc.chol_reference(torch.from_numpy(make_spd(rng, b, t)).to(dev, dtype)).contiguous()
            y = torch.from_numpy(rng.normal(size=(b, t))).to(dev, dtype)
            want = lc.solve_vec_reference(l, y)

            def two_solves():
                z = torch.linalg.solve_triangular(l, y[..., None], upper=False)
                return torch.linalg.solve_triangular(l.mT, z, upper=True)

            n = reps if t < 1000 else max(1, reps // 10)
            layouts = ["resident", "streamed"] if lc._solve_vec_layout(t, dtype) == "resident" else ["streamed"]
            for layout in layouts:
                if layout == "streamed":
                    lc.SOLVE_VEC_RESIDENT_T_CAP[dtype] = 0
                try:
                    got = lc.solve_vec(l, y)
                    fwd = lc.solve_vec_forward(l, y)
                    err = max(rel(g, w) for g, w in zip(got, want))
                    same = torch.equal(fwd[0], got[0]) and torch.equal(fwd[1], got[2])
                    ok &= err < TOL[dtype] and same
                    full, lib = in_turns(lambda: lc.solve_vec(l, y), two_solves, n)
                    forward = cuda_ms(lambda: lc.solve_vec_forward(l, y), n)
                    graphed = [graph_ms(f, n) for f in (lambda: lc.solve_vec(l, y),
                                                        lambda: lc.solve_vec_forward(l, y), two_solves)]
                finally:
                    lc.SOLVE_VEC_RESIDENT_T_CAP.update(caps)
                # What one block (one matrix) streams: the triangle's bytes over the
                # forward-only launch's time in a graph.
                rate = t * (t + 1) / 2 * l.element_size() / (graphed[1] * 1e-3) / 1e9
                print(f"  solve_vec B={b} T={t} {str(dtype)[6:]} {layout}: rel err {err:.1e}, forward-only "
                      f"equal {same}; kernel {full:.4f} ms, forward-only {forward:.4f} ms, two "
                      f"solve_triangular {lib:.4f} ms; in a CUDA graph: kernel {graphed[0]:.4f}, forward-only "
                      f"{graphed[1]:.4f}, two solve_triangular {graphed[2]:.4f} ms; {rate:.1f} GB/s a block")
    return ok


def sweep(dev, reps):
    for dtype in (torch.float32, torch.float64):
        for t in (1, 16, 32, 33, 48, 64, 65, 96, 128, 160, 165) + ((192, 224, 239) if dtype == torch.float32 else ()):
            rng = np.random.default_rng(t)
            k = torch.from_numpy(make_spd(rng, 16, t)).to(dev, dtype)
            y = torch.from_numpy(rng.normal(size=(16, t))).to(dev, dtype)
            l = lc.chol_reference(k).contiguous()
            ms = [cuda_ms(f, reps) for f in (lambda: lc.chol(k), lambda: lc.tri_inv(l),
                                             lambda: lc.chol_solve(k, y))]
            print(f"  sweep B=16 T={t} {str(dtype)[6:]}: chol {ms[0]:.4f} ms, tri_inv {ms[1]:.4f} ms, "
                  f"chol_solve {ms[2]:.4f} ms")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--reps", type=int, default=200, help="launches per timing turn")
    parser.add_argument("--sweep", action="store_true", help="also time the kernels over T at B = 16")
    parser.add_argument("--only", choices=["solve_vec"], help="only the vector solve")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    _build.library()
    print(f"built in {_build.build_info['seconds']:.1f} s")
    lines = _build.build_info["log"].splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and any(s in line for s in ("chol", "tri_inv", "solve_vec")):
            print("  " + line.split("Compiling entry function")[1].strip())
            for follow in lines[i + 1:i + 4]:
                if "registers" in follow or "spill" in follow:
                    print("    " + follow.replace("ptxas info    :", "").strip())
    if args.only == "solve_vec":
        return 0 if solve_vec_times(dev, args.reps) else 1
    ok = check(dev)
    times(dev, args.reps)
    if args.sweep:
        sweep(dev, args.reps)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
