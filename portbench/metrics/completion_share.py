"""completion_share (program counter): streams that ended in the window
with all their tokens, over the streams that ended in it, in %: the
simulation's outcome (the paper's SSR), not a failure of the program."""


def read(run):
    done = [s for s in run.record.streams if s.finished]
    if not done:
        return None
    full = sum(len(s.output) >= s.max_new_tokens for s in done)
    return 100.0 * full / len(done)
