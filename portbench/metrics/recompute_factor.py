"""recompute_factor (program counter): the positions the routed window
loop's stage forwards compute (B·S·layers, each hop's payload holding its
stream's whole prefix; prefill chunks, repairs and hedge backups
included) over the positions the simulation charges them (ntok·layers,
the prefix less the peer's warm KV): ``stage/positions`` over
``stage/fresh`` of the program's counters, over the run's window (the
set-up's warm-up calls the stages directly, never through a hop).
Nothing for a program without the counters or a run without a hop."""
from portbench import spans


def read(run):
    c = spans.stage_counters()
    if c is None or c["fresh"] <= 0:
        return None
    return c["positions"] / c["fresh"]
