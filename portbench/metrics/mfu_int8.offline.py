"""mfu_int8.offline: the whole step's share of the card's int8 peak: the
useful int8 operations of the window's waves (portbench.lm_yardstick:
every W8A8 product of the prefill and the decode steps, experts counted
by their routed assignments, not the padded capacity) over the window's
seconds, over 1,979e12, in %."""
from portbench.yardstick import PEAK_INT8_OPS


def read(run):
    if run.window_s <= 0 or not run.waves:
        return None
    return 100.0 * run.wave_ops * run.waves / run.window_s / PEAK_INT8_OPS
