"""The training step's share of the card's peak: three times the forward
FLOPs of every image issued (forward, input and weight gradients), over
the traced window."""
from readers import mfu


def read(r):
    return mfu(r, passes=3)
