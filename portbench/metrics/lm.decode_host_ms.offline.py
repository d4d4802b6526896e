"""lm.decode_host_ms.offline: the lm.decode_step span (the host's call of
LM.decode_step: Python and launches, no wait for the card) over the
traced run's window, a step, in ms.  Against lm.decode_step_ms.offline
it says whether decode is host-bound."""

NAME = "lm.decode_step"


def read(run):
    t = (run.spans or {}).get(NAME)
    if not t:
        return None
    return sum(b - a for a, b in t) / len(t) * 1e3
