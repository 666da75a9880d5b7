"""Online serving: dynamic batcher + HTTP endpoint over the predict program
(``python -m sports_field_homography_tpu_torch.serve.server``)."""
from .batcher import DynamicBatcher, default_buckets

__all__ = ["DynamicBatcher", "default_buckets"]
