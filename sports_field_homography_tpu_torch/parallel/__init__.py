"""Data parallelism across processes: one rank per device, a
``torch.distributed`` process group between them (``distributed.py``),
the batch splits, the gradient all-reduce and the sharded predict
(``mesh.py``)."""
