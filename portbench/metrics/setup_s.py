"""setup_s: process start to the first timed request (kernels loaded,
weights drawn, PTQ, the cell's buckets warmed), host clock."""


def read(run):
    return run.setup_s
