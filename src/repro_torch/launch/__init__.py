"""Command-line launchers of the port (counterpart of ``repro.launch``):
``python -m repro_torch.launch.serve``,
``python -m repro_torch.launch.cluster`` and
``python -m repro_torch.launch.train``.  Each runs on the card unless
``--device cpu`` is given.  ``mesh`` builds meshes over the process group
and spawns CPU gloo ranks; ``specs`` builds the production cells."""
