"""route_ms (harness span): ms per routing window that ``route_window``
adds to the critical path: its wall time, less the wait for the stage
work queued on the card before its call (from a CUDA event recorded at
the call to one recorded at its return; on the CPU its wall time)."""


def read(run):
    r = run.record
    if not r.route_calls:
        return None
    return 1e3 * r.route_s / r.route_calls
