"""Command-line entry points (port of ``repro.launch``)."""
