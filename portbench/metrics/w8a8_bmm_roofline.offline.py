"""w8a8_bmm_roofline.offline: the expert products' (w8a8_bmm, the batched
face of csrc/w8a8_dense.cu) least time over their device time in a wave,
from the profiled stretch, in % (portbench.lm_yardstick.roofline: useful
work, routed assignments, the weights of the experts each call reached
read once)."""
from portbench.lm_yardstick import roofline


def read(run):
    return roofline(run, "bmm")
