"""Check and time the Matern-3/2 Gram kernels (``csrc/gram_matern32.cu``) on
the card at the fit's shapes.

Run from the repository root on a machine with an NVIDIA GPU and nvcc::

    python3 -m bayesian_ensembling_tpu_torch.utils.gram_times [--reps 50] [--json PATH]

It builds the kernels, prints what ptxas reports for them, and at the annual
fits (112, 165) and (112, 86), one gridded model's cells (2,592, 86), the
gridded step's batch (41,472, 86) and the monthly campaign's (65, 1032) and
(28, 1980) checks the build kernel bit for bit against its plain version,
then times with CUDA events, in float32 (float64 at the annual shapes):
the build kernel and the contraction kernel beside their bound (bytes over
3.35 TB/s: dist read and ky written; K^-1 and dist read) and their plain
versions, and the chain they replace in the fit (the Gram's elementwise
chain forward, the NLML's d/dK and autograd back to the two gradients)
beside the two kernels.  At the annual shapes the kernels are also timed
inside a CUDA graph of 20 launches, where the host's launch rate no longer
shows.  Exits non-zero if a check fails.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import torch

from bayesian_ensembling_tpu_torch import _build
from bayesian_ensembling_tpu_torch.ops import gp as gp_ops
from bayesian_ensembling_tpu_torch.ops import gram
from bayesian_ensembling_tpu_torch.ops import linalg_cuda as lc
from bayesian_ensembling_tpu_torch.utils.linalg_kernel_times import cuda_ms, graph_ms

SHAPES = ((112, 165), (112, 86), (2592, 86), (41472, 86), (65, 1032), (28, 1980))
ANNUAL = ((112, 165), (112, 86))
HBM_BYTES_PER_S = 3.35e12


def inputs(b, t, dtype, seed=0):
    """Distances of 3-realisation random walks, hyperparameters, noise, a
    symmetric K^-1, alpha and the output weights, on the card."""
    gen = torch.Generator().manual_seed(seed)
    walk = torch.cumsum(0.1 * torch.randn((b, t, 3), generator=gen, dtype=dtype), dim=1)
    x = (torch.linspace(0.0, 1.0, t, dtype=dtype)[None, :, None] + walk).cuda()
    dist = gp_ops.get_kernel_precomputed("matern32")[0](x, x)
    small = dict(dtype=dtype, device="cuda")
    ls = 0.5 + torch.rand((b,), **small)
    var = 0.5 + torch.rand((b,), **small)
    noise = 0.01 + 0.2 * torch.rand((b, t), **small)
    kinv = torch.randn((b, t, t), **small)
    kinv = kinv.add_(kinv.mT.clone()).mul_(0.5)
    alpha = torch.randn((b, t), **small)
    half = torch.full_like(ls, 0.5)  # the fit's weights of quad and logdet
    return dist, ls, var, noise, kinv, alpha, half, half


def chain(dist, ls, var, noise, kinv, alpha, g_quad, g_logdet):
    """What the two kernels replace in one value and gradient of the fit:
    the chain's Gram, the NLML's d/dK, and autograd back to (ls, var)."""
    ls_, var_ = ls.detach().requires_grad_(True), var.detach().requires_grad_(True)
    ky = gram.gram_matern32_reference(dist, ls_, var_, noise, 1e-6)
    g_ky = lc.nlml_g_ky(kinv, alpha, g_quad, g_logdet)
    return torch.autograd.grad(ky, (ls_, var_), g_ky)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--reps", type=int, default=50, help="launches a timing")
    parser.add_argument("--json", help="also write the rows to this file")
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
        if "Compiling entry" in line and "gram" in line:
            used = next((x.strip() for x in lines[k + 1:k + 4] if "Used" in x), "")
            print(f"ptxas {line.split('entry function')[-1].strip()}: {used}")
    ok, rows = True, []
    print("dtype   B      T     build ms (bound, plain)          contraction ms (bound, plain)"
          "     chain ms  kernels ms  [in a graph: build, contraction]")
    for dtype in (torch.float32, torch.float64):
        for b, t in SHAPES if dtype == torch.float32 else ANNUAL:
            a = inputs(b, t, dtype)
            dist, ls, var, noise = a[:4]
            grad_args = (a[4], a[5], a[6], a[7], dist, ls, var)
            same = torch.equal(gram.gram_matern32(dist, ls, var, noise, 1e-6),
                               gram.gram_matern32_reference(dist, ls, var, noise, 1e-6))
            ok &= same
            reps = max(3, args.reps if b * t * t < 10 ** 8 else args.reps // 10)
            e = dtype.itemsize
            bound = 2 * b * t * t * e / HBM_BYTES_PER_S * 1e3
            row = dict(dtype=str(dtype)[6:], b=b, t=t, equal=same, bound_ms=bound,
                       build_ms=cuda_ms(lambda: gram.gram_matern32(dist, ls, var, noise, 1e-6),
                                        reps),
                       grad_ms=cuda_ms(lambda: gram.gram_matern32_grad(*grad_args), reps),
                       build_plain_ms=cuda_ms(lambda: gram.gram_matern32_reference(
                           dist, ls, var, noise, 1e-6), reps),
                       grad_plain_ms=cuda_ms(lambda: gram.gram_matern32_grad_reference(
                           *grad_args), reps),
                       chain_ms=cuda_ms(lambda: chain(*a), reps))
            if (b, t) in ANNUAL:
                row.update(build_graph_ms=graph_ms(
                    lambda: gram.gram_matern32(dist, ls, var, noise, 1e-6), args.reps),
                           grad_graph_ms=graph_ms(
                    lambda: gram.gram_matern32_grad(*grad_args), args.reps))
            rows.append(row)
            graphed = (f"  [{row['build_graph_ms']:.4f}, {row['grad_graph_ms']:.4f}]"
                       if "build_graph_ms" in row else "")
            print(f"{row['dtype']:7s} {b:<6d} {t:<5d} {row['build_ms']:.4f} ({bound:.4f}, "
                  f"{row['build_plain_ms']:.4f}){'' if same else ' NOT EQUAL'}"
                  f"      {row['grad_ms']:.4f} ({bound:.4f}, {row['grad_plain_ms']:.4f})"
                  f"      {row['chain_ms']:.4f}    {row['build_ms'] + row['grad_ms']:.4f}{graphed}",
                  flush=True)
            del a, dist, grad_args
            torch.cuda.empty_cache()
    if args.json:
        with open(args.json, "w") as f:
            json.dump(dict(device=smi, rows=rows), f, indent=1)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
