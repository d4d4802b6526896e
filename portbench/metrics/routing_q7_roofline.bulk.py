"""routing_q7_roofline.bulk: the least time of csrc/routing_q7.cu's calls in the
profiled stretch (portbench.yardstick.kernel_bound_s at each wave's
bucket: bytes read once and written once over 3.35e12 B/s, or
operations over the int8 peak, whichever is larger) over their profiler
device time, in %.  One call a wave, or nothing is read."""
from portbench.yardstick import kernel_bound_s

KERNEL = "routing_q7"


def read(run):
    p = run.profile
    if p is None or not p.waves:
        return None
    calls = p.calls(KERNEL)
    if len(calls) != len(p.waves) or not sum(calls):
        return None
    bound = sum(kernel_bound_s(KERNEL, run.cell.config, b) for b, _ in p.waves)
    return 100.0 * bound / sum(calls)
