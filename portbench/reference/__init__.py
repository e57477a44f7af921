"""The plain reference of the benchmark's cells.

Plain PyTorch, written from the definitions of the ensemble step: classic
DBA (``dba.py``), the exact heteroskedastic GP fit and its posterior
marginals (``gp.py``), and the CRPS weights and W2 barycentre (``tail.py``);
``steps.py`` puts them together for each entry of the port that a cell
drives.  It imports nothing of the port and takes nothing the port made: it
works the DBA targets, the hyperparameters and the marginals out again from
the same inputs.
"""
