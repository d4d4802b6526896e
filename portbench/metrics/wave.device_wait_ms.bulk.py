"""wave.device_wait_ms.bulk: the engine's serve.d2h span (the copies of
the wave's outputs to the host, which wait for the card to finish the
wave: its backlog when the host has issued the last launch) a wave,
over the traced run's unprofiled stretch, in ms.  Nothing is read where
the program opens no such span."""

NAME = "serve.d2h"


def read(run):
    spans, st = run.spans or {}, run.stretch
    ex = spans.get("serve.execute")
    if not ex or st is None or len(ex) != len(st["waves"]):
        return None
    t = spans.get(NAME, [])
    if len(t) < len(ex):
        return None
    return sum(t[-len(ex):]) / len(ex) * 1e3
