"""The distributed layer (port of ``repro.distributed``): sharding rules
and DTensor placements, collectives, the pipeline, elastic re-meshing."""
