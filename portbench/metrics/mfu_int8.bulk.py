"""mfu_int8.bulk: the whole step's share of the card's int8 peak: two
operations a multiply-accumulate of every completed image's int8
forward (portbench.yardstick.layer_macs) a second of the traced run's
unprofiled stretch, over 1,979e12, in %."""
from portbench.yardstick import PEAK_INT8_OPS


def read(run):
    st = run.stretch
    if st is None or st["wall_s"] <= 0 or not st["completed"]:
        return None
    return 100.0 * run.image_ops * st["completed"] / st["wall_s"] \
        / PEAK_INT8_OPS
