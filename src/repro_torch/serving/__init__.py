"""Window-batched trust-routed serving (port of ``repro.serving``)."""
