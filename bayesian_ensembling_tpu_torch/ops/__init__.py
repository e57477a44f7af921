"""Batched compute cores: DTW/DBA, GP algebra, scoring, and their kernels."""
