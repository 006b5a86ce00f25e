"""itl_ms.p95 (host clock): the 95th percentile, over every pair of
consecutive tokens of every stream inside the window, of the wall-clock
gap between them, in ms."""
from portbench.harness import stream_gaps_ms
from portbench.yardstick import percentiles


def read(run):
    gaps = stream_gaps_ms(run.record.streams)
    if not gaps:
        return None
    return percentiles(gaps, (95,))[0]
