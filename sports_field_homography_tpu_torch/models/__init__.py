from .reconstructor import Input, Reconstructor, ReconstructorConfig

__all__ = ["Input", "Reconstructor", "ReconstructorConfig"]
