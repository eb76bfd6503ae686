"""Command-line launchers of the port (counterpart of ``repro.launch``):
``python -m repro_torch.launch.serve``,
``python -m repro_torch.launch.cluster``,
``python -m repro_torch.launch.train``,
``python -m repro_torch.launch.dryrun`` and
``python -m repro_torch.launch.hillclimb``.  Each runs on the card unless
``--device cpu`` is given (the dry run and the hillclimb count on the host
either way; the device is where their chip policies run).  ``mesh`` builds
meshes over the process group, spawns CPU gloo ranks and starts fake
worlds; ``specs`` builds the production cells."""
