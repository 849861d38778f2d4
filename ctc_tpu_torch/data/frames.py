"""JPEG frame loading and preprocessing for the pixels -> I3D path (a copy
of ``ctc_tpu/data/frames.py``).

The reference's per-frame torchvision pipeline (Resize(256/224 *
inputsize), CenterCrop(inputsize), ToTensor, Normalize(mean .5, std .5))
in PIL and numpy, producing channels-last ``[T, stack, h, w, 3]`` clip
stacks for :class:`ctc_tpu_torch.models.InceptionI3d`, and the
frame-number arithmetic of its windows (gap-strided 10-frame stacks).
"""

from __future__ import annotations

import os

import numpy as np

try:
    from PIL import Image
except ImportError:  # pragma: no cover
    Image = None

STACK = 10


def load_frame(path: str, inputsize: int = 224) -> np.ndarray:
    """One JPEG -> resized+cropped+normalized ``[h, w, 3]`` float32."""
    with open(path, "rb") as f:
        img = Image.open(f).convert("RGB")
    # torchvision Resize(shorter side = 256/224 * inputsize), bilinear
    target = int(256.0 / 224 * inputsize)
    w, h = img.size
    if w < h:
        nw, nh = target, int(round(h * target / w))
    else:
        nw, nh = int(round(w * target / h)), target
    img = img.resize((nw, nh), Image.BILINEAR)
    # CenterCrop(inputsize)
    left = (nw - inputsize) // 2
    top = (nh - inputsize) // 2
    img = img.crop((left, top, left + inputsize, top + inputsize))
    arr = np.asarray(img, np.float32) / 255.0
    return (arr - 0.5) / 0.5


def window_frame_paths(first_frame_path: str, gap: int, stack: int = STACK):
    """The reference's frame-number arithmetic (:758-764): from the window's
    t-th anchor frame path, the stack is ``base + (gap+1)*i`` for i<stack."""
    base = first_frame_path[:-10]  # strip 'NNNNNN.jpg'
    frame0 = int(first_frame_path[-10:-4])
    return [
        f"{base}{frame0 + (gap + 1) * i:06d}.jpg" for i in range(stack)
    ]


def load_window(
    anchor_paths, gap: int, *, inputsize: int = 224, stack: int = STACK
) -> np.ndarray:
    """``[T]`` anchor frame paths -> ``[T, stack, h, w, 3]`` float32 clip."""
    clips = []
    for p in anchor_paths:
        frames = [
            load_frame(fp, inputsize)
            for fp in window_frame_paths(p, gap, stack)
        ]
        clips.append(np.stack(frames))
    return np.stack(clips)
