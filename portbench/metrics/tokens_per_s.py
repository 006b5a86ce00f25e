"""tokens_per_s (host clock): every token emitted in the window over the
window's wall seconds."""


def read(run):
    return run.record.tokens / run.window.length
