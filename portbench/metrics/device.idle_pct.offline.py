"""device.idle_pct.offline: 1 - (a wave's device-busy seconds, from the
profiled stretch: portbench.lm_yardstick.wave_busy_s) / (the median wall
time of the window's waves, which the profiler does not slow), in %."""
import statistics

from portbench.lm_yardstick import wave_busy_s


def read(run):
    busy = wave_busy_s(run)
    if busy is None or not run.wave_s:
        return None
    return 100.0 * (1.0 - busy / statistics.median(run.wave_s))
