"""wave.execute_ms.bulk: the engine's serve.execute span (the wave
function, ended by the copy of its outputs to the host) a wave, over the
traced run's unprofiled stretch, in ms."""


def read(run):
    ex = (run.spans or {}).get("serve.execute")
    if not ex or run.stretch is None or \
            len(ex) != len(run.stretch["waves"]):
        return None
    return sum(ex) / len(ex) * 1e3
