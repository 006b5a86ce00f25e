"""decode_step_ms (harness span): wall ms per ``_decode`` call of the
engine, each timed from its call to the end of its device work, mean
over the window's steps."""


def read(run):
    steps = run.record.decode_steps
    if not steps:
        return None
    return 1e3 * sum(steps) / len(steps)
