"""Cached I3D clip features (port of the feature-cache contract of
``ctc_tpu/data/features.py``).

Training reads features that were extracted once, ``[N, T, 1024]`` float32
per prepared split, from ``.npy`` files opened with ``mmap_mode="r"``.  The
extractor itself (the frozen I3D over JPEG windows) is pixels mode, ROADMAP
Queue 1 item 12: :class:`I3DFeatureExtractor` and
:func:`extract_split_features` keep their names and raise until it lands.
"""

from __future__ import annotations

import os

import numpy as np


def extraction_not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} extracts I3D features, which is not ported to "
        "ctc_tpu_torch yet (ROADMAP.md Queue 1 item 12); pass "
        "--features-dir with cached features"
    )


def load_features(path: str) -> np.ndarray:
    """The cached ``[N, T, F]`` features at ``path``, memory-mapped; a
    missing file is an error, never a silent re-extraction."""
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"--features-dir is set but {path} does not exist"
        )
    return np.load(path, mmap_mode="r")


class I3DFeatureExtractor:
    """Frozen-I3D clip-feature extractor (not ported yet)."""

    def __init__(self, *args, **kwargs):
        raise extraction_not_ported("I3DFeatureExtractor")


def extract_split_features(data, extractor, out_dir, **kwargs):
    """Extract and cache the features of a prepared split (not ported
    yet)."""
    raise extraction_not_ported("extract_split_features")
