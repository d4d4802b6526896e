"""tokens_per_s: tokens generated in the window (batch x gen a wave, whole
waves only) over the window's seconds, host clock."""


def read(run):
    return run.tokens / run.window_s if run.window_s > 0 else None
