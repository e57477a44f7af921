"""Where the cycles of the Cholesky, Cholesky-solve and triangular-inverse
kernels, of the DBA-update and squared-DTW cost kernels, and of the vector
solve go, phase by phase, on the card.

Run from the repository root on a machine with an NVIDIA GPU and nvcc::

    python3 -m bayesian_ensembling_tpu_torch.utils.linalg_phase_clocks [--sizes 165 128 86]
        [--threads 256 512] [--only linalg|dtw|solve_vec]

For a card whose profilers (ncu, nsys) are out of reach, the kernels carry
``BET_PHASE_CLOCK()`` marks that compile to nothing in the library's own
build.  This script compiles ``csrc/chol.cu``, ``csrc/chol_solve.cu`` and
``csrc/tri_inv.cu`` once more with ``-DBET_PHASE_CLOCKS`` (one library per
source, beside the package's own, in ``build/torch_kernels/``), launches
each at B = 16 and reads the SM cycle counter that thread 0 of block 0
recorded at every mark: the load, then per 32-column panel the diagonal
block (beside it, in the solve, the update of the rows under the previous
panel), the rows under it and the trailing update (beside it, in the solve,
the forward substitution of the panel), the backward substitution (by
panels, in the solve), the store; for the inverse the diagonal blocks
and the two products of every doubling level.  ``--threads`` rebuilds the two
Cholesky kernels with another block size (the inverse needs its 16 warps).
Each result is checked against torch.linalg before its clocks are printed.

``csrc/dba_update.cu`` and ``csrc/dtw_cost.cu`` are built the same way and
launched at N = 112 (the subgradient DBA's launch: fewer pairs than SMs, a
pair's chain alone) and N = 3,248 (the classic DBA and the epoch cost: every
SM full) for T in ``--sizes``, at every band height H the fused kernel is
built for and at the cost kernel's own.  The marks of block 0's first pair:
the load, the wavefront (as warp 0 of the pair sees it), then the walk back
from the corner and the row sums with their stores (the fused kernel) or the
store (the cost kernel); beside them the cycles of a wavefront step and of a
move of the walk.  Each result is checked bit for bit against the plain
version.

``--only solve_vec`` builds ``csrc/solve_vec.cu`` the same way and launches
it at B = 16 (B = 28 past T = 1,000), full and forward-only, for T in
``--sizes``: in the resident layout the wait for panel 0's rows, then each
forward panel (the chain and the rows below) and each backward panel; in
the streamed layout the solver warp's stalls (waiting for the dot products
or the ring) and its chains, per pass.  Each result is checked against the
plain version, the forward-only z and logdet bit for bit against the full
launch's.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys

import numpy as np
import torch

from bayesian_ensembling_tpu_torch import _build

# source stem -> (pointer arguments, int arguments)
KERNELS = {"chol": (2, 2), "chol_solve": (6, 2), "tri_inv": (2, 2), "dba_update": (4, 4),
           "dtw_cost": (3, 4), "solve_vec": (5, 3)}


def build(name, threads):
    """Compile ``csrc/<name>.cu`` with the phase clocks on; returns the loaded library."""
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = _build.BUILD_DIR / f"phase_clocks_{name}_{threads}.so"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-DBET_PHASE_CLOCKS", f"-DBET_CHOL_THREADS={threads}",
           "-shared", "-o", str(so), str(_build.CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed: {' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    notes = [line.strip() for line in (proc.stdout + proc.stderr).splitlines()
             if "registers" in line or "spill" in line]
    lib = ctypes.CDLL(str(so))
    for suffix in ("f32", "f64"):
        fn = getattr(lib, f"bet_{name}_{suffix}")
        n_ptr, n_int = KERNELS[name]
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.bet_phase_clocks.argtypes = [ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(ctypes.c_int)]
    lib.bet_phase_clocks.restype = ctypes.c_int
    return lib, notes


def phases(lib):
    """Cycles between consecutive marks of the last launch."""
    marks = (ctypes.c_longlong * 256)()
    n = ctypes.c_int()
    rc = lib.bet_phase_clocks(marks, ctypes.byref(n))
    if rc != 0:
        raise RuntimeError(f"bet_phase_clocks: CUDA error {rc}")
    return np.diff(np.array(marks[: n.value])).tolist()


def make_spd(rng, b, t):
    """Matern-3/2 Grams on sorted 1-D inputs plus noise, as the GP fit sees."""
    x = np.sort(rng.normal(size=(b, t)), axis=1)
    d = np.abs(x[:, :, None] - x[:, None, :]) / 1.3
    k = (1.0 + np.sqrt(3.0) * d) * np.exp(-np.sqrt(3.0) * d)
    return k + rng.uniform(0.05, 0.2, size=(b, t))[:, :, None] * np.eye(t)


def launch(lib, symbol, *args):
    for _ in range(3):  # the last launch's marks are read; the first two warm the caches
        rc = getattr(lib, symbol)(*args, None)
        if rc != 0:
            raise RuntimeError(f"{symbol}: CUDA error {rc}")
    return phases(lib)


def rel(got, want):
    return ((got - want).abs().max() / want.abs().max().clamp(min=1.0)).item()


def dtw_clocks(sizes):
    """Phases of the DBA-update and cost kernels of one pair (block 0)."""
    from bayesian_ensembling_tpu_torch.ops import dtw_cuda

    dba, notes = build("dba_update", 0)
    print("dba_update:", "; ".join(notes))
    cost, notes = build("dtw_cost", 0)
    print("dtw_cost:", "; ".join(notes))
    ok = True
    for dtype, sfx in ((torch.float32, "f32"), (torch.float64, "f64")):
        e = dtype.itemsize
        for t in sizes:
            for n in (112, 3248):
                gen = torch.Generator().manual_seed(t)
                c = torch.randn((n, t), generator=gen, dtype=dtype).cuda()
                s = torch.randn((n, t), generator=gen, dtype=dtype).cuda()
                want_s, want_c = dtw_cuda.dba_update_batch_reference(c, s)
                rule = dtw_cuda._fused_layout(t, e)
                for h in dtw_cuda._FUSED_HEIGHTS:
                    ppb = rule[1] if h == rule[0] else 1
                    if 32 * dtw_cuda._warps(t, h) * ppb > dtw_cuda._MAX_THREADS:
                        continue
                    sums, counts = torch.empty_like(c), torch.empty_like(c)
                    d = launch(dba, f"bet_dba_update_{sfx}", c.data_ptr(), s.data_ptr(), sums.data_ptr(),
                               counts.data_ptr(), n, t, h, ppb)
                    exact = torch.equal(sums, want_s) and torch.equal(counts, want_c)
                    ok &= exact
                    steps = t + min(32, dtw_cuda._bands(t, h)) - 1
                    moves = int(counts[0].sum().item()) - 1
                    mark = "*" if (h, ppb) == rule else " "
                    print(f"{mark}{sfx} N={n} T={t} dba_update H={h} pairs/block={ppb}: {sum(d)} cycles; "
                          f"load {d[0]}, wavefront {d[1]} ({d[1] / steps:.0f} a step of warp 0), "
                          f"walk {d[2]} ({moves} moves, {d[2] / max(moves, 1):.0f} a move), "
                          f"row sums and stores {d[3]}; exact {exact}")
                h, ppb = dtw_cuda._cost_layout(t, e)
                out = torch.empty(n, dtype=dtype, device="cuda")
                d = launch(cost, f"bet_dtw_cost_{sfx}", c.data_ptr(), s.data_ptr(), out.data_ptr(),
                           n, t, h, ppb)
                exact = torch.equal(out, dtw_cuda.squared_dtw_cost_batch_reference(c, s))
                ok &= exact
                steps = t + min(32, dtw_cuda._bands(t, h)) - 1
                print(f"*{sfx} N={n} T={t} dtw_cost H={h} pairs/block={ppb}: {sum(d)} cycles; load {d[0]}, "
                      f"wavefront {d[1]} ({d[1] / steps:.0f} a step), store {d[2]}; exact {exact}")
    return ok


def solve_vec_clocks(sizes):
    """Phases of the vector solve's block 0 at B = 16 (B = 28 past T = 1000),
    full and forward-only, each checked against the plain version (the
    forward-only z and logdet bit for bit against the full launch's)."""
    from bayesian_ensembling_tpu_torch.ops import linalg_cuda as lc

    lib, notes = build("solve_vec", 0)
    print("solve_vec:", "; ".join(notes))
    ok = True
    for dtype, sfx in ((torch.float32, "f32"), (torch.float64, "f64")):
        tol = 1e-3 if dtype == torch.float32 else 1e-10
        for t in sizes:
            layout = lc._solve_vec_layout(t, dtype)
            b = 28 if t > 1000 else 16
            rng = np.random.default_rng(t)
            l = torch.linalg.cholesky(torch.from_numpy(make_spd(rng, b, t))).to("cuda", dtype).contiguous()
            y = torch.from_numpy(rng.normal(size=(b, t))).to("cuda", dtype)
            want = lc.solve_vec_reference(l, y)
            flags = 2 if layout == "streamed" else 0
            out = {}
            for fwd in (0, 1):
                z, alpha = torch.empty_like(y), torch.empty_like(y)
                logdet = torch.empty(b, device="cuda", dtype=dtype)
                d = launch(lib, f"bet_solve_vec_{sfx}", l.data_ptr(), y.data_ptr(), z.data_ptr(),
                           alpha.data_ptr(), logdet.data_ptr(), b, t, flags | fwd)
                out[fwd] = (z, alpha, logdet, d)
            z, alpha, logdet, d = out[0]
            err = max(rel(g, w) for g, w in zip((z, alpha, logdet), want))
            same = torch.equal(out[1][0], z) and torch.equal(out[1][2], logdet)
            ok &= err < tol and same
            np_ = -(-t // 32)
            head = (f"{sfx} B={b} T={t} solve_vec {layout}: {sum(d)} cycles (forward-only {sum(out[1][3])}); "
                    f"rel err {err:.1e}; forward-only equal {same}")
            if layout == "resident":
                fwd, bwd = d[1:1 + np_], d[1 + np_:]
                print(f"{head}\n    load wait {d[0]}; forward panels {fwd} ({sum(fwd) / t:.1f} cycles an "
                      f"unknown); backward panels {bwd} ({sum(bwd) / t:.1f} an unknown)")
            else:
                stalls, chains_ = d[0::2], d[1::2]
                print(f"{head}\n    forward: stalls {sum(stalls[:np_])} (first {stalls[0]}), chains "
                      f"{sum(chains_[:np_])} ({sum(chains_[:np_]) / t:.1f} a link); backward: stalls "
                      f"{sum(stalls[np_:])}, chains {sum(chains_[np_:])}; marks recorded {len(d)}")
    return ok


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--sizes", type=int, nargs="+", default=[165, 128, 86], help="T of the matrices")
    parser.add_argument("--threads", type=int, nargs="+", default=[256],
                        help="block sizes of the two Cholesky kernels")
    parser.add_argument("--only", choices=["linalg", "dtw", "solve_vec"], help="one family of kernels")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    ok = True
    if args.only == "solve_vec":
        return 0 if solve_vec_clocks(args.sizes) else 1
    if args.only != "linalg":
        ok &= dtw_clocks(args.sizes)
    if args.only == "dtw":
        return 0 if ok else 1
    b = 16
    inv, notes = build("tri_inv", args.threads[0])
    print("tri_inv:", "; ".join(notes))
    for threads in args.threads:
        chol, notes = build("chol", threads)
        print(f"chol, {threads} threads:", "; ".join(notes))
        solve, notes = build("chol_solve", threads)
        print(f"chol_solve, {threads} threads:", "; ".join(notes))
        for dtype, sfx in ((torch.float32, "f32"), (torch.float64, "f64")):
            tol = 1e-3 if dtype == torch.float32 else 1e-10
            for t in args.sizes:
                rng = np.random.default_rng(t)
                k = torch.from_numpy(make_spd(rng, b, t)).to("cuda", dtype)
                y = torch.from_numpy(rng.normal(size=(b, t))).to("cuda", dtype)
                want_l = torch.linalg.cholesky(k).contiguous()
                l, w = torch.empty_like(k), torch.empty_like(k)
                z, alpha = torch.empty_like(y), torch.empty_like(y)
                logdet = torch.empty(b, device="cuda", dtype=dtype)

                d = launch(chol, f"bet_chol_{sfx}", k.data_ptr(), l.data_ptr(), b, t)
                err = rel(l, want_l)
                panels = [d[i:i + 3] for i in range(1, len(d) - 1, 3)]
                print(f"{sfx} T={t} chol ({threads} threads): {sum(d)} cycles; load {d[0]}; panels "
                      f"[diagonal block, rows, trailing] {panels}; store {d[-1]}; rel err {err:.1e}")
                ok &= err < tol

                d = launch(solve, f"bet_chol_solve_{sfx}", k.data_ptr(), y.data_ptr(), l.data_ptr(),
                           z.data_ptr(), alpha.data_ptr(), logdet.data_ptr(), b, t)
                want_alpha = torch.cholesky_solve(y[..., None], want_l)[..., 0]
                err = max(rel(l, want_l), rel(alpha, want_alpha))
                panels = [d[i:i + 3] for i in range(1, len(d) - 2, 3)]
                print(f"{sfx} T={t} chol_solve ({threads} threads): {sum(d)} cycles; load {d[0]}; panels "
                      f"[diagonal block, rows, hook and trailing] {panels}; backward {d[-2]}; "
                      f"store {d[-1]}; rel err {err:.1e}")
                ok &= err < tol

                if threads == args.threads[0]:
                    d = launch(inv, f"bet_tri_inv_{sfx}", want_l.data_ptr(), w.data_ptr(), b, t)
                    err = rel(w, torch.linalg.inv(want_l))
                    levels = [d[i:i + 2] for i in range(2, len(d) - 1, 2)]
                    print(f"{sfx} T={t} tri_inv (512 threads): {sum(d)} cycles; load {d[0]}; diagonal "
                          f"blocks {d[1]}; levels [L21 W11, -W22 P] {levels}; store {d[-1]}; "
                          f"rel err {err:.1e}")
                    ok &= err < tol
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
