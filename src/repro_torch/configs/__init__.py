"""Architecture configurations of the port (counterpart of
``repro.configs``): the same published numbers, one module per arch."""
