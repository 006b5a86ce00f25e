"""Stage partitioning (port of ``repro.distributed``)."""
