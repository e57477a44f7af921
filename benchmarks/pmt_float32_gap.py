"""The perfect-model scores' float32 gap (ROADMAP C14): ``batched_pmt`` in
float32 against float64 at the same posteriors, in the PyTorch port (on the
CPU, and on the card where there is one) and, where JAX is installed, in the
JAX package on the CPU.

Run from the repository root:

    JAX_PLATFORMS=cpu python benchmarks/pmt_float32_gap.py [--nits 100]

Two sets of inputs: those of tests/test_torch_validation.py (4 models, 2 to 4
realisations, T = 14) and the flagship's scenario 0
(``chip_smoke.synthetic_flagship``: 16 models, 2 to 29 realisations,
T = 165 / 86), the scale of chip_smoke.py's phase 11.  The posteriors are the
port's ``GPDTW1D`` fitted in float64 on the CPU and cast to float32; every
float64 run takes those float32 values cast back (on the CPU), so each row
scores the same posteriors and only the arithmetic's precision differs, as
phase 11 holds the card's float32 scores to float64 ones.  Prints, per set,
package, device and weight kind, the largest gap over the rmse / w2 / crps
columns (degC) with its column, and over the nll columns (relative), as
``chip_smoke.pmt_gaps`` measures them.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

KINDS = ("crps", "loglik", "ksd", "inverse_square", "uniform")


def validation_triples(seed, n_models=4, counts=(2, 3, 4), t=14, start="2000-01"):
    """tests/test_torch_validation.py's ``arrays``: realisations around a
    per-model level, monthly time."""
    rng = np.random.default_rng(seed)
    time = (np.datetime64(start, "M") + np.arange(t)).astype("datetime64[ns]")
    time = time + np.timedelta64(14, "D")
    return [(rng.normal(size=(counts[i % len(counts)], t)) + 0.3 * i, time, f"model{i}")
            for i in range(n_models)]


def flagship_triples():
    """Scenario 0 of chip_smoke.py's flagship inputs: historical and SSP
    triples of its 16 real models on yearly time."""
    import chip_smoke

    hb, hm, sb, sm, _, mm = chip_smoke.synthetic_flagship(0)

    def years(start, n):
        return (np.datetime64(str(start), "Y") + np.arange(n)).astype("datetime64[ns]")

    t_h, t_s = years(1850, hb.shape[-1]), years(1850 + hb.shape[-1], sb.shape[-1])
    return [[(block[k, : int(mask[k].sum())], time, f"model{k}")
             for k in range(block.shape[0]) if mm[0, k] > 0]
            for block, mask, time in ((hb[0], hm[0], t_h), (sb[0], sm[0], t_s))]


def fitted_blobs(tbet, torch, triples, nits):
    """The port's collection of ``triples``, GPDTW1D-fitted in float64 on the
    CPU, as blobs whose floats hold float32 values."""
    mc = tbet.ModelCollection([
        tbet.ProcessModel(tbet.DimArray(v.copy(), ("realisation", "time"), {"time": t.copy()},
                                        name="tas"), name)
        for v, t, name in triples
    ])
    mc.fit(tbet.GPDTW1D(dtype=torch.float64), n_optim_nits=nits, dba_iterations=10, device="cpu")
    return cast(mc._to_blobs(), np.float32)


def cast(blobs, dtype):
    return {k: v.astype(dtype) if v.dtype.kind == "f" else v for k, v in blobs.items()}


def gaps(got, want):
    """(largest degC gap, its column, largest relative nll gap)."""
    import chip_smoke

    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    degc, nll = chip_smoke.pmt_gaps(got, want)
    cols = chip_smoke.DEGC_COLS
    per = np.abs(got[:, cols] - want[:, cols]).max(axis=0)
    return degc, chip_smoke.PMT_COLUMNS[cols[int(per.argmax())]], nll


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nits", type=int, default=100, help="Adam steps of the float64 fits")
    args = ap.parse_args(argv)

    import torch

    import bayesian_ensembling_tpu_torch as tbet

    try:  # the JAX package, where it imports (it needs jax and h5py)
        import jax

        jax.config.update("jax_enable_x64", True)
        from bayesian_ensembling_tpu import validation as jvalidation
        from bayesian_ensembling_tpu.data import ModelCollection as JMC
        without_jax = None
    except ImportError as e:
        without_jax = str(e)
    devices = ["cpu"] + (["cuda"] if torch.cuda.is_available() else [])
    sets = {"validation tests (M=4, T=14)": (validation_triples(0), validation_triples(1)),
            "flagship scenario 0 (M=16, T=165/86)": tuple(flagship_triples())}
    for label, (hind, fore) in sets.items():
        b32 = [fitted_blobs(tbet, torch, t, args.nits) for t in (hind, fore)]
        b64 = [cast(b, np.float64) for b in b32]
        ref64 = [tbet.ModelCollection._from_blobs(b, list(b), device="cpu") for b in b64]
        runs = [("torch", dev, [tbet.ModelCollection._from_blobs(b, list(b), device=dev)
                                for b in b32], ref64, tbet.batched_pmt) for dev in devices]
        if without_jax is None:
            runs.append(("jax", "cpu", [JMC._from_blobs(b, list(b)) for b in b32],
                         [JMC._from_blobs(b, list(b)) for b in b64], jvalidation.batched_pmt))
        for pkg, dev, c32, c64, score in runs:
            for kind in KINDS:
                got = np.asarray(score(*c32, kind))
                want = np.asarray(score(*c64, kind))
                assert got.dtype == np.float32 and want.dtype == np.float64, (got.dtype, want.dtype)
                degc, col, nll = gaps(got, want)
                print(f"{label}  {pkg} {dev:4s}  {kind:14s}  float32 vs float64: max |d| "
                      f"{degc:.3e} degC ({col}), nll {nll:.3e} relative", flush=True)
    card = (torch.cuda.get_device_name(0) if torch.cuda.is_available() else "no card")
    print(f"torch {torch.__version__}; {card}; the JAX package "
          f"{'used' if without_jax is None else 'not imported: ' + without_jax}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
