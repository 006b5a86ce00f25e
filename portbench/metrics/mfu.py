"""mfu (program counter over the host clock): the operations the window's
served work needs in a KV-cache deployment (each prompt token once, each
emitted token once, attention over its prefix, the routed experts only;
``yardstick.token_flops``), over the window's wall seconds times the
card's bf16 peak, in %. Prefixes the program recomputes are not
counted. The profiler's stop inside a traced window
(``trace.SliceProfiler.stop_in_window_s``) is left out of its time."""
from portbench.yardstick import BF16_FLOP_PER_S


def read(run):
    if run.record.flops <= 0:
        return None
    busy = run.window.length - run.profiler.stop_in_window_s
    return 100.0 * run.record.flops / (busy * BF16_FLOP_PER_S)
