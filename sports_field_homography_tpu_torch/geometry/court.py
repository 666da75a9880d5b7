"""Court points of interest (port of ``geometry/court.py``,
``load_court_poi`` only)."""
from __future__ import annotations

import json

import numpy as np

__all__ = ["load_court_poi"]


def load_court_poi(path: str) -> np.ndarray:
    """Load court points of interest from JSON as (N, 2) in [-1, 1] (the
    JSON stores them in [0, 1])."""
    try:
        with open(path) as f:
            data = json.load(f)
        if data["ranges"][0] != 1.0 or data["ranges"][1] != 1.0:
            raise ValueError(f"ranges {data['ranges']} are not [1.0, 1.0]")
        points = []
        for p in data["points"]:
            points.append(((p["coords"][0] - 0.5) * 2, (p["coords"][1] - 0.5) * 2))
        return np.array(points)
    except (OSError, KeyError, IndexError, TypeError, ValueError) as e:
        raise ValueError(f"Cannot read {path}: {e}") from e
