"""Groundtruth lookup-table IO (port of ``ctc_tpu/utils/groundtruth.py``).

The reference ships a precomputed pickle (``utils/groundtruth.p``, wired via
``--groundtruth-lookup``) mapping video id -> list of (scene, object, verb)
triplets.  This loads that exact format (and anything
:func:`ctc_tpu_torch.data.charades.prepare_windows` /
``prepare_ver2_groundtruth`` produce) and saves new tables compatibly.
"""

from __future__ import annotations

import pickle


def load_groundtruth(path: str) -> dict:
    """``{vid: [[s, o, v], ...]}`` from a reference-format pickle."""
    with open(path, "rb") as f:
        table = pickle.load(f)
    return {vid: [list(map(int, row)) for row in rows]
            for vid, rows in table.items()}


def save_groundtruth(path: str, table: dict) -> None:
    with open(path, "wb") as f:
        pickle.dump(table, f)
