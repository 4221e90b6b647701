"""Batch inference over an exported model: the part of the JAX package's
``tools/run_model.py`` that the port's HTTP server needs.

``_to_jsonable`` (numpy rows -> JSON values) is a copy of the original's.
The batch CLI replays an ``api/export`` artifact and comes with the port
of ``api/export`` (ROADMAP A12).
"""

from __future__ import annotations

from typing import Any

import numpy as np


def _to_jsonable(row: Any) -> Any:
    if isinstance(row, dict):
        return {k: _to_jsonable(v) for k, v in row.items()}
    if isinstance(row, np.ndarray):
        return row.tolist()
    if isinstance(row, (np.generic,)):
        return row.item()
    return row
