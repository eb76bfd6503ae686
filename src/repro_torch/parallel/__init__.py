"""Distribution over a device mesh: sharding rules and placement
(``sharding``), and the GPipe pipeline schedule (``pipeline``)
(counterpart of ``repro.parallel``)."""
