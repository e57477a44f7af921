"""fit.blocked_ms: milliseconds the card's stream took over the optimiser
loops on the ``blocked`` route (the recursive blocked NLML on the Cholesky
and triangular-inverse kernels) in one step run with the port's tracer on:
the ``fit.loop`` spans' CUDA-event times whose ``route`` attribute is
``blocked``, summed under the step's root (``portbench/fit_loops.py``).
0.0 where the loops carry a route and none is ``blocked``; nothing to read
where the loops carry no route."""

from portbench import fit_loops


def read(ctx):
    return fit_loops.route_ms(ctx, "blocked")
