"""The benchmark of the PyTorch and CUDA port, ``bayesian_ensembling_tpu_torch``.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell once; ``README.md`` says how a configuration, a cell or a
metric is added.
"""
