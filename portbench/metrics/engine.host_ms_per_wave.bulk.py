"""engine.host_ms_per_wave.bulk: the host's time a wave outside
serve.execute (submits, padding, completions, the generator), over the
traced run's unprofiled stretch, in ms."""


def read(run):
    ex = (run.spans or {}).get("serve.execute")
    if not ex or run.stretch is None or \
            len(ex) != len(run.stretch["waves"]):
        return None
    return (run.stretch["wall_s"] - sum(ex)) / len(ex) * 1e3
