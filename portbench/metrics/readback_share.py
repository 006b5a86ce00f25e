"""readback_share (program span): the host's time blocked reading device
values back, over the traced slice's wall time (which leaves the
profiler's stop out), in %: the program's ``loop.readback`` (each routed
token), ``route.readback`` (the router's plans) and ``engine.readback``
(each decode step's tokens) spans. Nothing where the program opens none
of its spans."""
from portbench import spans


def read(run):
    r = spans.slice_ranges(run)
    if r is None or not r.spans or r.wall_s <= 0:
        return None
    return 100.0 * spans.readback_ns(r.spans) / 1e9 / r.wall_s
