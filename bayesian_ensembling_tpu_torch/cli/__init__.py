"""Port-side entry points of the repository's scripts: the three CLIs of
``experiments/`` and the two ``data_download/`` scripts that read the
package.  Each runs as ``python -m bayesian_ensembling_tpu_torch.cli.<name>``
with the JAX script's arguments and outputs; the experiment CLIs add
``--device`` (the card by default).  They read netCDF through h5py and
draw with matplotlib or tabulate with pandas, imported on use."""
