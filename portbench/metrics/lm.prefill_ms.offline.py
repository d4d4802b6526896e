"""lm.prefill_ms.offline: the harness's lm.prefill span (the host's call of
LM.prefill, which returns before the card finishes) summed over the
traced run's window, over its waves, in ms."""

NAME = "lm.prefill"


def read(run):
    t = (run.spans or {}).get(NAME)
    if not t or not run.waves:
        return None
    return sum(b - a for a, b in t) / run.waves * 1e3
