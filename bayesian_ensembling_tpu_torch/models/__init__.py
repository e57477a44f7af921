"""Emulator families: mean-field Gaussian and GPDTW1D."""
