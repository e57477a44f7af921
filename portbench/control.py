"""The readings that a cell's limits are set from, at the cell's own size.

    python3 portbench/control.py --workload <cell> --seeds <n> [<n> ...] [--program 1]
        [--fault <name>]

For each seed: the pool entry a run with every entry finished would compare
(``run._sampled``), its answers from the plain reference in float64 (the
comparison's), from the control (the same reference put in the program's
place and computed one precision below the configuration's, ``CONTROL``),
and with ``--program 1`` from one step of the port as the window runs it.
Prints, for each number a run compares, the control's reading and the
program's, one JSON line a seed, and last the largest program reading and
the smallest control reading over the seeds.  A reading above the cell's
limit is a run that comes out not correct: the control has to.  With
``--fault`` the program's step also runs once with that fault of
``portbench/faults.py`` planted (side ``fault``): a fault the cell catches
reads over a limit.  Each side also gives, for each output and statistic,
the readings of its rows (the leading axis) alone: all of them where there
are 64 rows or fewer, else their quantiles ``ROW_QUANTILES``.  Runs on the
card.

The ladder of the control's precision, by the configuration's dtype:

* float32 (which every cell runs with TF32 off): the reference in float32
  with TF32 on, on the pool entry as the cell draws it;
* float64: the reference in float32 with TF32 off, on the pool entry's
  floats rounded once to float32 (TF32 does not touch float64: the
  float64 reference with TF32 on is the reference itself).
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench import faults, run  # noqa: E402


# The control of each configuration dtype: (the dtype it computes in, TF32 on).
CONTROL = {"float32": ("float32", True), "float64": ("float32", False)}
QUANTILES = (0.1, 0.25, 0.5, 0.9, 0.99, 1.0)
ROW_QUANTILES = (0.5, 0.9, 0.99, 1.0)


def row_readings(diff):
    """Each statistic of each row of the gaps ``diff`` alone, sorted (or
    its quantiles where there are many rows)."""
    rows = diff.reshape(diff.shape[0], -1)
    out = {}
    for name, stat in run.STATISTICS.items():
        values = np.sort(stat(rows))
        out[name] = [float(v) for v in (values if len(values) <= 64
                                        else np.quantile(values, ROW_QUANTILES))]
    return out


@contextlib.contextmanager
def tf32(torch, on: bool):
    """TF32 in matrix products switched ``on`` (restored after)."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    torch.set_float32_matmul_precision("high" if on else "highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved[:2]
        torch.set_float32_matmul_precision(saved[2])


def readings(cell, seed, device, program=False, witness=False, fault=None):
    """``{"control": {number: value}, "program": {number: value}}`` of one
    seed, and the quantiles of each side's pointwise gaps."""
    import torch

    from portbench.traffic import generate

    config, profile = cell.config, cell.profile
    entry = importlib.import_module(f"portbench.entries.{config['entry']}")
    inputs = generate.pool(config, seed, cell.workload["pool"])
    k = run._sampled(seed, range(cell.workload["pool"]))
    x = inputs[k]
    x64 = {key: a.astype(np.float64) if a.dtype != bool else a for key, a in x.items()}
    reference = entry.reference
    out = {"seed": seed, "entry": k}
    answers = {}
    t0 = time.perf_counter()
    with tf32(torch, False):
        want = reference(x64, config, profile, device, torch.float64)
    out["reference_s"] = time.perf_counter() - t0
    below, tf32_on = CONTROL[config["dtype"]]
    x_below = {key: a.astype(below) if a.dtype != bool else a for key, a in x.items()}
    with tf32(torch, tf32_on):
        answers["control"] = reference(x_below, config, profile, device, getattr(torch, below))
    if program:
        import bayesian_ensembling_tpu_torch as bt

        with tf32(torch, False):
            t = entry.tensors(x, getattr(torch, config["dtype"]), device)
            answers["program"] = run._host(entry.step(bt, t, config, profile))
            if fault:
                with faults.planted(fault, config):
                    answers["fault"] = run._host(entry.step(bt, t, config, profile))
            if witness:
                t = entry.tensors(x64, torch.float64, device)
                answers["program_float64"] = run._host(entry.step(bt, t, config, profile))
    for side, got in answers.items():
        out[side] = run.compared_numbers(cell.workload["checks"], entry.OUTPUTS, got, want)
        out[side + "_quantiles"] = {  # the pointwise gaps' quantiles QUANTILES
            name: [float(q) for q in np.quantile(np.abs(got[j].astype(np.float64) - want[j]),
                                                 QUANTILES)]
            for j, name in enumerate(entry.OUTPUTS)}
        out[side + "_rows"] = {
            name: row_readings(np.abs(got[j].astype(np.float64) - want[j]))
            for j, name in enumerate(entry.OUTPUTS)}
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--program", type=int, choices=(0, 1), default=0)
    parser.add_argument("--witness", type=int, choices=(0, 1), default=0,
                        help="with --program 1, also the port in float64")
    parser.add_argument("--fault", default=None, choices=sorted(faults.FAULTS),
                        help="with --program 1, also the port with this fault planted")
    args = parser.parse_args(argv)
    import torch

    cell = run.Cell.named(args.workload)
    device = run.require_devices(torch, cell.chips)
    rows = []
    for seed in args.seeds:
        rows.append(readings(cell, seed, device, bool(args.program), bool(args.witness),
                             args.fault))
        print(json.dumps(rows[-1]), flush=True)
    for name, check in cell.workload["checks"].items():
        control = min(r["control"][name] for r in rows)
        line = f"{name}: control least {control!r} (limit {check['limit']!r})"
        if args.program:
            line += f", program most {max(r['program'][name] for r in rows)!r}"
        if args.fault:
            line += f", {args.fault} least {min(r['fault'][name] for r in rows)!r}"
        print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
