"""wave.h2d_ms.bulk: the wave function's wave.h2d span (the padded
batch's pageable copy to the card) a wave, over the traced run's
unprofiled stretch, in ms.  Set-up's warm-up waves open it first, so
the stretch's are the last; nothing is read where the program opens no
such span."""

NAME = "wave.h2d"


def read(run):
    spans, st = run.spans or {}, run.stretch
    ex = spans.get("serve.execute")
    if not ex or st is None or len(ex) != len(st["waves"]):
        return None
    t = spans.get(NAME, [])
    if len(t) < len(ex):
        return None
    return sum(t[-len(ex):]) / len(ex) * 1e3
