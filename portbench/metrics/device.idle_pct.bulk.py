"""device.idle_pct.bulk: 1 - (the union of device operations a wave in
the profiled stretch) / (host wall a wave in the unprofiled stretch
before it), in %.  The union does not depend on the host's speed, which
the profiler slows; the unprofiled wall does not carry its cost."""


def read(run):
    p, st = run.profile, run.stretch
    if p is None or st is None or not p.waves or not st["waves"]:
        return None
    busy = p.busy_s() / len(p.waves)
    wall = st["wall_s"] / len(st["waves"])
    return 100.0 * (1.0 - busy / wall)
