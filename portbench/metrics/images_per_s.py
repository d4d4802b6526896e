"""images_per_s: images completed inside the window over the whole
window's seconds, host clock."""


def read(run):
    return run.completed / run.window_s if run.window_s > 0 else None
