"""Simulated edge peers and testbed (port of ``repro.sim``)."""
