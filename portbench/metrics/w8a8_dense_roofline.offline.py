"""w8a8_dense_roofline.offline: the dense W8A8 products' (attention's
q, k, v, o and the head, csrc/w8a8_dense.cu) least time over their
device time in a wave, from the profiled stretch, in %
(portbench.lm_yardstick.roofline)."""
from portbench.lm_yardstick import roofline


def read(run):
    return roofline(run, "dense")
