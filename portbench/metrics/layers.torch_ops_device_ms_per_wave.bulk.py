"""layers.torch_ops_device_ms_per_wave.bulk: the profiler's device time a
wave of every kernel other than squash_q7 and routing_q7 (the int8 convs,
one launch each of csrc/conv_q7.cu, and u_hat, shifts and saturation as
torch ops), in ms."""

KERNELS = ("squash_q7", "routing_q7")


def read(run):
    p = run.profile
    if p is None or not p.waves:
        return None
    t = sum(d for name, _, d, _ in p.kernels()
            if not any(k in name for k in KERNELS))
    return t / len(p.waves) * 1e3
