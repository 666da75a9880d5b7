"""Kernels launched in the traced predict window per frame issued."""
from readers import launches_per_unit


def read(r):
    return launches_per_unit(r, "frames_issued")
