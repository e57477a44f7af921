"""Check and time the DBA-update and squared-DTW cost kernels on the card at
every band layout they are built for.

Run from the repository root on a machine with an NVIDIA GPU and nvcc::

    python3 -m bayesian_ensembling_tpu_torch.utils.dtw_kernel_times [--reps 200]

It builds the kernels, prints what ptxas reports for ``csrc/dba_update.cu``
and ``csrc/dtw_cost.cu`` (registers, spills), and at the shapes the paths
launch them at (the subgradient DBA's N = 112 and epoch cost N = 3,248, the
classic DBA's N = 3,248, the medoid pairs, the monthly T = 1980, and T = 720
for the fused kernel against the split one) holds every layout (band height
H, pairs a block) bit for bit against the plain version in float32 and
times it with CUDA events; the layout the launcher's rule picks is marked
``*``.  The fused kernel's time at N = 112 is also given inside a CUDA
graph of 20 launches, where the host's launch rate no longer shows.  These
are the numbers the rules in ``ops/dtw_cuda.py`` (``_fused_layout``,
``_cost_layout``, ``FUSED_AUTO_T_MAX``) were chosen from.  Exits non-zero
if a check fails.
"""

from __future__ import annotations

import argparse
import subprocess
import sys

import torch

from bayesian_ensembling_tpu_torch import _build
from bayesian_ensembling_tpu_torch.ops import dtw_cuda
from bayesian_ensembling_tpu_torch.utils.linalg_kernel_times import cuda_ms, graph_ms

# (N, T) of each kernel's paths.
FUSED_SHAPES = ((112, 165), (112, 86), (3248, 165), (3248, 86), (812, 720))
COST_SHAPES = ((3248, 165), (3248, 86), (45472, 165), (812, 1980))


def pairs(n, t, seed):
    gen = torch.Generator().manual_seed(seed)
    return (torch.randn((n, t), generator=gen).cuda(), torch.randn((n, t), generator=gen).cuda())


def fused_layouts(t):
    for h in dtw_cuda._FUSED_HEIGHTS:
        for ppb in (1, 2, 4):
            if (32 * dtw_cuda._warps(t, h) * ppb <= dtw_cuda._MAX_THREADS
                    and dtw_cuda._fused_smem_bytes(t, 4, h, ppb) <= _build.SMEM_BYTES):
                yield h, ppb


def cost_layouts(t):
    for h in dtw_cuda._COST_HEIGHTS[4]:
        if h * 32 < t / 16:  # more than 16 warps a pair
            continue
        for ppb in (1, 2, 4):
            if 32 * dtw_cuda._warps(t, h) * ppb <= dtw_cuda._MAX_THREADS:
                yield h, ppb


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--reps", type=int, default=200, help="launches a timing at N = 112")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    _build.library()
    lines = _build.build_info["log"].splitlines()
    for k, line in enumerate(lines):
        if "Compiling entry" in line and ("dba_update_kernel" in line or "dtw_cost_kernel" in line):
            used = next((x.strip() for x in lines[k + 1:k + 4] if "Used" in x), "")
            print(f"ptxas {line.split('entry function')[-1].strip()}: {used}")
    ok = True

    for n, t in FUSED_SHAPES:
        c, s = pairs(n, t, t)
        want = dtw_cuda.dba_update_batch_reference(c, s)
        rule = dtw_cuda._fused_layout(t, 4)
        reps = args.reps if n * t * t < 1e8 else 20
        for h, ppb in fused_layouts(t):
            got_s, got_c = torch.empty_like(c), torch.empty_like(c)

            def run(h=h, ppb=ppb, got_s=got_s, got_c=got_c):
                dtw_cuda._launch_fused(c, s, got_s, got_c, h, ppb)

            run()
            torch.cuda.synchronize()
            exact = torch.equal(got_s, want[0]) and torch.equal(got_c, want[1])
            ok &= exact
            ms = cuda_ms(run, reps)
            g_ms = graph_ms(run, reps) if n <= 132 else None
            mark = "*" if (h, ppb) == rule else " "
            print(f"{mark} dba_update N={n} T={t} H={h} pairs/block={ppb} warps/pair="
                  f"{dtw_cuda._warps(t, h)}: exact={exact} {ms:.4f} ms"
                  + (f", in a graph {g_ms:.4f} ms" if g_ms is not None else ""))
        if t > dtw_cuda.FUSED_AUTO_T_MAX:
            split = dtw_cuda.dba_update_batch(c, s, impl="split")
            torch.cuda.synchronize()
            exact = torch.equal(split[0], want[0]) and torch.equal(split[1], want[1])
            ok &= exact
            ms = cuda_ms(lambda: dtw_cuda.dba_update_batch(c, s, impl="split"), reps)
            print(f"  dba_update_split N={n} T={t}: exact={exact} {ms:.4f} ms")
        del want
        torch.cuda.empty_cache()

    for n, t in COST_SHAPES:
        c, s = pairs(n, t, t + 1)
        want = dtw_cuda.squared_dtw_cost_batch_reference(c, s)
        rule = dtw_cuda._cost_layout(t, 4)
        reps = 50 if n * t * t < 2e9 else 5
        for h, ppb in cost_layouts(t):
            out = torch.empty(n, device="cuda")

            def run(h=h, ppb=ppb, out=out):
                dtw_cuda._launch_cost(c, s, out, h, ppb)

            run()
            torch.cuda.synchronize()
            exact = torch.equal(out, want)
            ok &= exact
            ms = cuda_ms(run, reps)
            mark = "*" if (h, ppb) == rule else " "
            print(f"{mark} dtw_cost N={n} T={t} H={h} pairs/block={ppb} warps/pair="
                  f"{dtw_cuda._warps(t, h)}: exact={exact} {ms:.4f} ms")

    print("all exact" if ok else "A LAYOUT DISAGREES WITH THE PLAIN VERSION")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
