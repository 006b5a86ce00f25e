"""cast_share (device trace): device time under ``aten::_to_copy`` (the
dtype conversions: weights cast to the activation type at each matmul,
activations to f32 in the norms and the rotary) over all device time in
the traced slice, in %."""


def read(run):
    s = run.summary
    if not s or s["device_s"] <= 0 or "aten::_to_copy" not in s["by_op"]:
        return None
    return 100.0 * s["by_op"]["aten::_to_copy"] / s["device_s"]
