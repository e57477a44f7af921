"""The ensemble step over a batch of scenarios and models."""
