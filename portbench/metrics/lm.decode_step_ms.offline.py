"""lm.decode_step_ms.offline: the median wall time between the starts of
consecutive lm.decode_step spans of one wave, over the traced run's
window, in ms: the decode pace, host- or device-bound."""
import statistics

NAME = "lm.decode_step"


def read(run):
    t = (run.spans or {}).get(NAME)
    per_wave = run.gen - 1
    if not t or per_wave < 2 or len(t) != run.waves * per_wave:
        return None
    d = [t[i + 1][0] - t[i][0] for i in range(len(t) - 1)
         if (i + 1) % per_wave]
    return statistics.median(d) * 1e3
