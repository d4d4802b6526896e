"""ptq_s: seconds of the port's PTQ in set-up, the sum of its spans
ptq.calibrate, ptq.plan and ptq.quantize_weights."""

NAMES = ("ptq.calibrate", "ptq.plan", "ptq.quantize_weights")


def read(run):
    if not run.spans or not all(run.spans.get(n) for n in NAMES):
        return None
    return sum(sum(run.spans[n]) for n in NAMES)
