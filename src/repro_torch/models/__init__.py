"""Model compute for the served stages (port of ``repro.models``)."""
