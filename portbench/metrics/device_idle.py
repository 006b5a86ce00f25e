"""device_idle (device trace): the share of the traced slice's wall time
in which no kernel ran on the card, in %."""


def read(run):
    s = run.summary
    if not s or s["wall_s"] <= 0:
        return None
    return 100.0 * max(0.0, 1.0 - s["busy_s"] / s["wall_s"])
