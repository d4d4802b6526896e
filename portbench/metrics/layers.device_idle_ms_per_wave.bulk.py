"""layers.device_idle_ms_per_wave.bulk: the profiled stretch's idle
seconds between device operations whose innermost host range is one of
the int8 forward's layer.<name> ranges (the card waiting on a layer's
launches), a wave, in ms.  Nothing is read where the trace holds no
such range."""

PREFIX = "layer."


def read(run):
    p = run.profile
    if p is None or not p.waves:
        return None
    names = {r[0] for r in p.host_ranges}
    if not any(n.startswith(PREFIX) for n in names):
        return None
    # every name, and "none" where no range is open
    idle = sum(s for name, s in p.idle_by_host(len(names) + 1)
               if name.startswith(PREFIX))
    return idle / len(p.waves) * 1e3
