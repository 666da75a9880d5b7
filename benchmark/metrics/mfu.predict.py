"""The predict step's share of the card's peak: the forward FLOPs of every
frame issued, over the traced window."""
from readers import mfu


def read(r):
    return mfu(r, passes=1)
