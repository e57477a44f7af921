"""Port-side copies of the repository's ``examples/``: each runs as
``python -m bayesian_ensembling_tpu_torch.examples.<name>`` on the card
(``--device cpu`` on the CPU, ``--dtype float64`` for the float64 run),
prints the lines the JAX example prints, and its ``main(argv)`` returns the
numbers it printed.  Nothing runs at import."""

import argparse

import torch


def parse_args(argv, description: str) -> argparse.Namespace:
    """The examples' shared options: ``--device`` (the card by default) and
    ``--dtype`` (the emulators' working precision)."""
    ap = argparse.ArgumentParser(description=description.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="where to fit: 'cuda' (the default) or 'cpu'")
    ap.add_argument("--dtype", choices=["float32", "float64"], default="float32",
                    help="working precision of the fits (float32, as in the JAX examples)")
    args = ap.parse_args(argv)
    args.torch_dtype = getattr(torch, args.dtype)
    return args
