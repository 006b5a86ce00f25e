"""idle_in_model (device trace): of the traced slice's device-idle time
(its gaps between kernels of at least ``trace.GAP_MIN_S``, as the
breakdown takes them), the share whose gap's midpoint lies inside one of
the program's ``model.*`` or ``moe.*`` spans: the card waiting while the
host is in the model, in %. Nothing where the program opens no such span
or the slice has no gap."""
from portbench import spans


def read(run):
    r = spans.slice_ranges(run)
    if r is None or not any(n.startswith(("model.", "moe."))
                            for _, _, n in r.spans):
        return None
    inside, idle = spans.idle_within(spans.idle_gaps(r.busy), r.spans,
                                     ("model.", "moe."))
    if idle <= 0:
        return None
    return 100.0 * inside / idle
