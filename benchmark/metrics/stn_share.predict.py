"""Share of the card's busy time in cuDNN and cuBLAS kernels: the ResNet
STN's convolutions and head, with the UNet's 3-channel stem and 1x1
output head (a few percent of that group); its BatchNorm and ReLU are
elementwise kernels and not counted."""
from readers import group_share


def read(r):
    return group_share(r, ["cudnn_cublas"])
