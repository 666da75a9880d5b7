"""K2's share of its roofline in predict: the UNet's 3x3 convs after
the stem, counted from shapes, over the time of the kernels whose group
is op "conv3x3"."""
from counts import conv3x3_work
from readers import op_roofline


def read(r):
    return op_roofline(r, "conv3x3", lambda m, b, a: conv3x3_work(m, b, a, train=False))
