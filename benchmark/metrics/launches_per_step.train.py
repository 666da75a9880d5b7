"""Kernels launched in the traced training window per step issued."""
from readers import launches_per_unit


def read(r):
    return launches_per_unit(r, "units_issued")
