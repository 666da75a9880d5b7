"""sports-field-homography on PyTorch + CUDA (NVIDIA Hopper).

A port of the JAX package ``sports_field_homography_tpu`` (the reference it
is held against): UNet court segmentation, ResNet STN homography
regression and court-template warping.  Plain tensor code is PyTorch; the
kernels the JAX package wrote in Pallas are hand-written CUDA in
``csrc/``, built on first use (``ops/build.py``).  This package imports
``torch`` and never ``jax``.
"""

__version__ = "0.1.0"
