"""moe_bmm_share (device trace): device time under ``aten::bmm`` (the
expert products of ``models/moe.py``) over all device time in the traced
slice, in %; nothing for a configuration without experts."""


def read(run):
    s = run.summary
    if not s or s["device_s"] <= 0 or run.cfg.family != "moe":
        return None
    t = s["by_op"].get("aten::bmm", 0.0)
    if t <= 0:
        return None
    return 100.0 * t / s["device_s"]
