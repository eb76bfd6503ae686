"""Data (counterpart of ``repro.data``): the stateless synthetic LM batch
pipeline."""
