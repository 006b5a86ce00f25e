"""warm_hit_rate (program counter): ``ServeMetrics.kv_warm_hits`` over
hits plus ``kv_cold_steps``, summed over the window's streams, in %."""


def read(run):
    hits = sum(s.warm_hits for s in run.record.streams)
    cold = sum(s.cold_steps for s in run.record.streams)
    if hits + cold == 0:
        return None
    return 100.0 * hits / (hits + cold)
