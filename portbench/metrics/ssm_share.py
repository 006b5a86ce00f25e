"""ssm_share (device trace): the device time of the kernels launched
inside the program's ``model.ssm`` spans (a Mamba2 layer's mixer, norm1
to the residual add: ``models/transformer.py``), over all device time in
the traced slice, in %. A kernel belongs to the span that holds the start
of the host call that launched it (its runtime launch, found by the
correlation id), read from the raw kineto events of the slice whose
summary the run reports, as ``portbench/spans.py`` reads them. Nothing
for a program that opens no such span."""
import bisect

from portbench import spans

SPAN = "model.ssm"


def device_ns(sl):
    """(ns of device time launched inside ``SPAN``, ns of all device
    time) of one profiled slice, read once and kept in it."""
    if "ssm_device_ns" in sl:
        return sl["ssm_device_ns"]
    from torch.autograd import DeviceType
    events = list(sl["prof"].profiler.kineto_results.events())
    launch = {}
    ranges = []
    for e in events:
        if e.device_type() != DeviceType.CUDA:
            launch[e.correlation_id()] = e.start_ns()
            if e.name() == SPAN:
                ranges.append((e.start_ns(), e.start_ns() + e.duration_ns()))
    cover = spans.merge(ranges)
    starts = [a for a, _ in cover]
    inside = total = 0
    for e in events:
        if e.device_type() != DeviceType.CUDA or e.is_user_annotation():
            continue
        d = e.duration_ns()
        total += d
        t = launch.get(e.linked_correlation_id())
        if t is None:
            continue
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and cover[i][1] >= t:
            inside += d
    sl["ssm_device_ns"] = (inside, total) if cover else None
    return sl["ssm_device_ns"]


def read(run):
    sl = spans.chosen_slice(run)
    if sl is None:
        return None
    got = device_ns(sl)
    if not got or got[1] <= 0:
        return None
    return 100.0 * got[0] / got[1]
