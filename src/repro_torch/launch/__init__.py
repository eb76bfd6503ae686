"""Command-line launchers of the port (counterpart of ``repro.launch``):
``python -m repro_torch.launch.serve`` and
``python -m repro_torch.launch.cluster``.  Each runs on the card unless
``--device cpu`` is given."""
