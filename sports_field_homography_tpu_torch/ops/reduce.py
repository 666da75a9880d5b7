"""Deterministic column sums on the card (``csrc/sum_rows.cu``).

The second pass of the cross-block reductions in the training kernels:
each block of K2+stats, K5, K7-fwd's stats and K3-bwd writes a row of
partial sums, and ``column_sums`` adds the rows in a fixed order, one pass per
level of a tree of at most 65535-row chunks.  No float atomics: two runs on
the same input are bitwise equal.  CUDA tensors only; the plain versions
of those kernels take their sums with ``torch.sum``.
"""
from __future__ import annotations

import torch

from . import _dispatch
from .build import check, load_library

__all__ = ["column_sums", "rows_per_block", "split_reduction"]

_MIN_ROWS_PER_BLOCK = 256
_MAX_CHUNKS = 65535          # gridDim.y / gridDim.z

_TILE = 64                   # kBM = kBN in csrc/tile_gemm.cuh
_STAGE = 16                  # kBK
_TARGET_BLOCKS = 1024        # enough blocks in flight for 132 SMs
_MAX_CHUNK = 4096            # pixels one block sums in sequence
_MAX_PARTIAL_BYTES = 256 << 20


def rows_per_block(m: int) -> int:
    """Rows one block sums in a pass over m rows: at least
    _MIN_ROWS_PER_BLOCK, and few enough blocks for one grid dimension."""
    return max(_MIN_ROWS_PER_BLOCK, -(-m // _MAX_CHUNKS))


def split_reduction(m: int, rows: int, cols: int, stage: int = _STAGE,
                    tile_cols: int = _TILE):
    """(m_chunk, splits) for a weight-gradient GEMM whose (rows, cols)
    output sums over m pixels in (64, tile_cols) tiles, ``stage`` pixels a
    step: enough splits to fill the card, and at most _MAX_CHUNK pixels
    summed in sequence by one block (an f32 running sum over n terms drifts
    like sqrt(n) ulps), within the partials' memory cap.  m_chunk is a
    multiple of ``stage``."""
    tiles = -(-rows // _TILE) * -(-cols // tile_cols)
    splits = max(-(-_TARGET_BLOCKS // tiles), -(-m // _MAX_CHUNK))
    splits = max(1, min(splits, _MAX_PARTIAL_BYTES // (4 * rows * cols),
                        -(-m // stage), _MAX_CHUNKS))
    chunk = -(-m // splits)
    chunk = -(-chunk // stage) * stage
    return chunk, -(-m // chunk)


def column_sums(t: torch.Tensor) -> torch.Tensor:
    """(R, C) float32 or bfloat16 CUDA tensor -> (C,) float32 sums."""
    if t.dim() != 2 or t.device.type != "cuda":
        raise ValueError(f"column_sums takes a 2-D CUDA tensor, got "
                         f"{tuple(t.shape)} on {t.device}")
    rows, cols = t.shape
    if rows == 0:
        return torch.zeros(cols, dtype=torch.float32, device=t.device)
    cur = t.contiguous()
    lib = load_library()
    with torch.cuda.device(t.device):
        while True:
            rpb = rows_per_block(rows)
            chunks = -(-rows // rpb)
            out = torch.empty((chunks, cols), dtype=torch.float32, device=t.device)
            check(lib.sfh_sum_rows(cur.data_ptr(), out.data_ptr(), rows, cols,
                                   rpb, _dispatch.dtype_code(cur.dtype),
                                   _dispatch.stream_handle(t.device)),
                  "column_sums")
            if chunks == 1:
                return out[0]
            cur, rows = out, chunks
