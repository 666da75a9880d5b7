"""K2's share of its roofline in training: the 3x3 convs' forward and
input gradients, over the time of the kernels whose group is op "conv3x3"."""
from counts import conv3x3_work
from readers import op_roofline


def read(r):
    return op_roofline(r, "conv3x3", lambda m, b, a: conv3x3_work(m, b, a, train=True))
