"""K5's share of its roofline: the weight gradients of the UNet's 3x3
convs after the stem, over the time of the kernels whose group is op
"wgrad3x3"."""
from counts import wgrad3x3_work
from readers import op_roofline


def read(r):
    return op_roofline(r, "wgrad3x3", wgrad3x3_work)
