"""forwards_per_token (harness counter): stage forwards in the window,
prefill chunks and repairs included, per token emitted."""


def read(run):
    r = run.record
    if not r.forwards or not r.tokens:
        return None
    return r.forwards / r.tokens
