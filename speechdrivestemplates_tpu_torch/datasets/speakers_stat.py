"""Per-speaker pose normalization statistics.

The numbers ship as a compressed npz beside this module (``speakers_stat.npz``,
keys ``{global|parted}/{speaker}/{mean,std,scale_factor}``), a copy of the
reference's per-speaker tables, loaded lazily.
"""

from __future__ import annotations

import os
import threading
from typing import Dict

import numpy as np

_STAT_PATH = os.path.join(os.path.dirname(__file__), "speakers_stat.npz")
_lock = threading.Lock()
_tables: Dict[str, Dict[str, Dict[str, np.ndarray]]] | None = None


def _load_tables() -> Dict[str, Dict[str, Dict[str, np.ndarray]]]:
    global _tables
    with _lock:
        if _tables is None:
            tables: Dict[str, Dict[str, Dict[str, np.ndarray]]] = {
                "global": {}, "parted": {}}
            with np.load(_STAT_PATH) as z:
                for key in z.files:
                    space, speaker, field = key.split("/")
                    tables[space].setdefault(speaker, {})[field] = z[key]
            _tables = tables
    return _tables


def get_speaker_stat(speaker: str, num_kp: int, parted: bool) -> Dict[str, np.ndarray]:
    """float32 copies of one speaker's stats: mean/std (242,), scale_factor ().
    Only the 121-keypoint tables exist."""
    if num_kp != 121:
        raise KeyError(f"no stats table for {num_kp} keypoints (only 121 exists)")
    tables = _load_tables()
    space = "parted" if parted else "global"
    if speaker not in tables[space]:
        raise KeyError(
            f"speaker {speaker!r} not in {space} stats table; known: "
            f"{sorted(tables[space])}")
    stat = tables[space][speaker]
    return {
        "mean": stat["mean"].astype(np.float32),
        "std": stat["std"].astype(np.float32),
        "scale_factor": np.float32(stat["scale_factor"]),
    }


def available_speakers(parted: bool) -> list[str]:
    return sorted(_load_tables()["parted" if parted else "global"])
