"""mfu.decode (program counter over the harness's spans): the operations
of the tokens the engine's decode steps emitted in the window (each at
its position, ``yardstick.token_flops``) over the summed wall time of
those steps, each timed to its end, times the card's bf16 peak, in %."""
from portbench.yardstick import BF16_FLOP_PER_S


def read(run):
    steps = sum(run.record.decode_steps)
    if steps <= 0 or run.record.decode_flops <= 0:
        return None
    return 100.0 * run.record.decode_flops / (steps * BF16_FLOP_PER_S)
