"""Trust protocol, route planner and routing DP (port of ``repro.core``)."""
