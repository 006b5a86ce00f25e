"""issue_us_per_layer (program span): the host's wall time in the model
calls per layer run, in the traced slice: the program's own
``model.stage``, ``model.prefill`` and ``model.decode`` spans less the
read-back spans nested in them, over the layers they ran (one
``model.attn`` span each), in us. Where the card is busy the host also
waits in these spans on a full launch queue, so this is the model calls'
wall and not their issue cost alone (``host_split.py`` gives the launch
time inside them). The spans are the profiler's ranges of the port's wall
spans (``spans.slice_ranges``); nothing where the program opens none."""
from portbench import spans


def read(run):
    r = spans.slice_ranges(run)
    if r is None:
        return None
    ns = spans.issue_ns_per_layer(r.spans)
    return None if ns is None else ns / 1e3
