"""Wall time of the annual 7-SSP step on the card, from the checkout it is run in.

Run from the root of a checkout on a machine with an NVIDIA GPU and nvcc::

    python3 -m bayesian_ensembling_tpu_torch.utils.annual_step_time [--nits 500] [--reps 3]

It times ``ensemble_multi_scenario_step`` on ``chip_smoke.py``'s synthetic
flagship inputs (7 SSPs x 16 models x 29 realisations, T = 165 / 86) at
``--nits`` Adam steps, each run ended by ``torch.cuda.synchronize()``.  The
fit is bound by the host's dispatch, and the host of a one-card machine is
shared, so two commits are compared only inside one call: unpack the other
commit beside this one (``git archive``) and run the script from each root in
turns (parent, change, parent, change, ...), then compare the fastest runs.
"""

from __future__ import annotations

import argparse
import os
import sys


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--nits", type=int, default=500, help="Adam steps of the fit")
    parser.add_argument("--reps", type=int, default=3, help="timed runs (the first also builds and warms up)")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, os.getcwd())
    import chip_smoke  # the checkout's own: its synthetic inputs and its run_slice

    import bayesian_ensembling_tpu_torch as bt

    inputs = chip_smoke.synthetic_flagship(args.seed)
    dev = torch.device("cuda")
    for rep in range(args.reps):
        dt, out = chip_smoke._wall(
            torch, lambda: chip_smoke.run_slice(torch, bt, inputs, dev, torch.float32, args.nits))
        finite = all(bool(torch.isfinite(a).all()) for a in out)
        print(f"{os.getcwd()} run {rep}: {dt:.3f} s for {args.nits} Adam steps "
              f"({dt / (2 * args.nits) * 1e3:.3f} ms per step and collection, DBA and tail included); "
              f"finite={finite}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
