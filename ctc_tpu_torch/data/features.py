"""I3D feature extraction and the on-disk feature cache (port of
``ctc_tpu/data/features.py``).

The reference's live training keeps the I3D frozen and trains only the
head, so clip features are extracted once (the frozen backbone over each
window's JPEG stacks, T folded into the batch) and cached per prepared
split as ``features.npy`` (``[N, T, 1024]`` float32); training then reads
them, as it reads ``--features-dir``'s files, with ``mmap_mode="r"``.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ctc_tpu_torch.data.native_loader import load_window_native
from ctc_tpu_torch.models.i3d import InceptionI3d


def load_features(path: str) -> np.ndarray:
    """The cached ``[N, T, F]`` features at ``path``, memory-mapped; a
    missing file is an error, never a silent re-extraction."""
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"--features-dir is set but {path} does not exist"
        )
    return np.load(path, mmap_mode="r")


class I3DFeatureExtractor:
    """The frozen I3D (running BatchNorm statistics, no gradient) on an
    explicit ``device``, ``cuda`` by default; ``model`` defaults to a
    randomly initialized :class:`InceptionI3d` without a logits head."""

    def __init__(self, model: InceptionI3d | None = None, *,
                 device="cuda"):
        self.device = torch.device(device)
        self.model = (model or InceptionI3d(num_classes=None)).to(
            self.device)
        self.model.requires_grad_(False)

    @torch.no_grad()
    def __call__(self, clips: np.ndarray) -> np.ndarray:
        """``[B, T, stack, h, w, 3]`` -> ``[B, T, 1024]`` float32."""
        x = torch.from_numpy(np.ascontiguousarray(clips, np.float32))
        return self.model(x.to(self.device), train=False).float().cpu(
        ).numpy()


def extract_split_features(data: dict, extractor, out_dir: str, *,
                           gap: int, batch_size: int = 8,
                           inputsize: int = 224) -> np.ndarray:
    """Extract and cache the features of every sample of a prepared split.

    Writes ``features.npy [N, T, 1024]`` into ``out_dir`` and returns it; a
    cached file with N rows is returned instead, memory-mapped.  The frames
    go through PIL, as ``ctc_tpu``'s extraction reads them."""
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "features.npy")
    n = len(data["rgb_image_paths"])
    if os.path.exists(path):
        cached = np.load(path, mmap_mode="r")
        if cached.shape[0] == n:
            return cached
    temporal = len(data["rgb_image_paths"][0])
    feats = None
    for i0 in range(0, n, batch_size):
        idx = range(i0, min(i0 + batch_size, n))
        clips = np.stack([
            load_window_native(data["rgb_image_paths"][i], gap,
                               inputsize=inputsize, decoder="pil")
            for i in idx
        ])
        out = extractor(clips)
        if feats is None:
            feats = np.zeros((n, temporal, out.shape[-1]), np.float32)
        feats[i0:i0 + len(out)] = out
    np.save(path, feats)
    return feats
