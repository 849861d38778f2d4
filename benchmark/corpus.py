"""The benchmark's Charades-format corpus, written from a seed.

The format is the one the Charades loaders read (the published corpus's
layout):

* ``Charades_v1_train.csv`` and ``Charades_v1_test.csv`` with the real
  columns; each video has a scene, a length in seconds and ``cXXX start
  end`` actions drawn so that their means are Charades' published ones
  (Sigurdsson et al., ECCV 2016: videos of 30 s, 66500 intervals over 9848
  videos, actions of 12.8 s).  The shapes of the draws are this module's:
  a video's length uniform on [24, 36] s, 1 + Poisson(5.75) actions, an
  action's length uniform on [6.4, 19.2] s, starting uniformly inside the
  video;
* ``rgb/<vid>/<vid>-NNNNNN.jpg``: frames at 24 fps over the whole video.
  Empty files where only the frame count is read (cached features); with
  ``jpeg``, a pool of ``JPEG_POOL`` smooth ``JPEG_SIZE`` images a video,
  frame j being image ``(j - 1) % JPEG_POOL``.  Each pool image is a file
  and its repeats are hard links to it, so a video costs ``JPEG_POOL``
  files of data and directory entries for the rest;
* ``features/features_<split>.npy``: ``[N, temporal, feat_dim]`` float32
  normals, ``N`` the split's windows (:mod:`benchmark.reference.data`).

The annotations come from a fixed stream (``LAYOUT_SEED``), so every seed
gives the same windows, batches of the same sizes and the same epoch
length; the seed draws the frames' pixels and the features.  So the CSVs
and the frame tree are written once and kept (a directory entry costs
about a quarter of a millisecond on the card's machine, and a tree holds
up to 700,000); each call writes the seed's pool images in place, which
every link then reads, and the features.  Nothing here imports the
program.
"""

from __future__ import annotations

import io
import json
import math
import os
import shutil
import time

import numpy as np

from benchmark.reference import data as ref_data
from benchmark.reference.classes import C_CLASSES, SCENE_TO_INT

PUBLISHED = {"video_s": 30.0, "actions": 66500 / 9848, "action_s": 12.8}
LAYOUT_SEED = 20160101
JPEG_SIZE = (384, 288)
JPEG_POOL = 8
JPEG_QUALITY = 90
HEADER = ("id,subject,scene,quality,relevance,verified,script,objects,"
          "descriptions,actions,length\n")
SPLITS = (("train", "Charades_v1_train.csv"), ("val", "Charades_v1_test.csv"))


def _draw(rng, vid):
    """One CSV row and the video's frame count."""
    scenes = list(SCENE_TO_INT)
    length = round(PUBLISHED["video_s"] * float(rng.uniform(0.8, 1.2)), 2)
    acts = []
    for _ in range(1 + int(rng.poisson(PUBLISHED["actions"] - 1))):
        dur = PUBLISHED["action_s"] * float(rng.uniform(0.5, 1.5))
        start = float(rng.uniform(0.0, length - dur))
        acts.append(f"c{int(rng.integers(0, C_CLASSES)):03d} "
                    f"{start:.2f} {start + dur:.2f}")
    scene = scenes[int(rng.integers(0, len(scenes)))]
    row = (f'{vid},S{int(rng.integers(0, 300)):03d},"{scene}",6,6,Yes,s,o,'
           f'd,"{";".join(acts)}",{length:.2f}\n')
    return row, math.ceil(length * ref_data.FPS)


def _video(rng, vid, temporal, gap, num_trans):
    """A video whose windows the loaders can build: the Charades windowing
    raises where a window holds more than ``temporal`` transition times
    with a new verb, so such a draw is drawn again."""
    while True:
        row, frames = _draw(rng, vid)
        label = ref_data.parse_rows([HEADER, row])[vid]
        try:
            ref_data.train_windows({vid: label}, {vid: frames}, "",
                                   temporal=temporal, gap=gap,
                                   num_trans=num_trans)
        except IndexError:
            continue
        return row, frames


def _jpeg_pool(rng) -> list[bytes]:
    """Encoded smooth images: random 12 x 9 colour grids resized
    bilinearly to ``JPEG_SIZE``."""
    from PIL import Image

    pool = []
    for _ in range(JPEG_POOL):
        grid = rng.integers(0, 256, (9, 12, 3), dtype=np.uint8)
        img = Image.fromarray(grid).resize(JPEG_SIZE, Image.BILINEAR)
        buf = io.BytesIO()
        img.save(buf, format="JPEG", quality=JPEG_QUALITY)
        pool.append(buf.getvalue())
    return pool


def _link_frames(d, vid, n, pool_size) -> None:
    """Frames 1..n of one video: the first ``pool_size`` are files (empty
    until :func:`_fill_pool`), the rest hard links to them."""
    os.makedirs(d, exist_ok=True)
    for j in range(1, n + 1):
        path = os.path.join(d, f"{vid}-{j:06d}.jpg")
        if j <= pool_size:
            open(path, "wb").close()
        else:
            os.link(os.path.join(d, f"{vid}-{(j - 1) % pool_size + 1:06d}.jpg"),
                    path)


def _fill_pool(d, vid, pool) -> int:
    """Write a video's pool images in place: every hard link to them reads
    the new frames.  Returns the bytes written."""
    for k, data in enumerate(pool):
        with open(os.path.join(d, f"{vid}-{k + 1:06d}.jpg"), "wb") as f:
            f.write(data)
    return sum(len(x) for x in pool)


def _layout(root, train_videos, val_videos, jpeg, temporal, gap,
            num_trans) -> dict:
    """The seed-independent part: the CSVs and the frame tree, written
    once under ``root`` and kept (``layout.json`` records what was
    written); returns the frame counts by split."""
    key = {"version": 1, "layout_seed": LAYOUT_SEED,
           "videos": [train_videos, val_videos], "jpeg": jpeg,
           "pool": JPEG_POOL if jpeg else 1,
           "geometry": [temporal, gap, num_trans]}
    marker = os.path.join(root, "layout.json")
    if os.path.exists(marker):
        with open(marker) as f:
            saved = json.load(f)
        if saved["key"] == key:
            return saved["counts"]
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    rng = np.random.default_rng([LAYOUT_SEED, 0])
    counts = {}
    for (split, name), n_videos in zip(SPLITS, (train_videos, val_videos)):
        counts[split] = {}
        with open(os.path.join(root, name), "w") as f:
            f.write(HEADER)
            for i in range(n_videos):
                vid = f"{split[0].upper()}{i:04d}"
                row, counts[split][vid] = _video(rng, vid, temporal, gap,
                                                 num_trans)
                f.write(row)
        for vid, n in counts[split].items():
            _link_frames(os.path.join(root, "rgb", vid), vid, n,
                         key["pool"])
    with open(marker, "w") as f:
        json.dump({"key": key, "counts": counts}, f)
    return counts


def write_corpus(root: str, *, seed: int, train_videos: int, val_videos: int,
                 feat_dim: int = 1024, jpeg: bool = False,
                 features: bool = True, temporal: int = 10, gap: int = 2,
                 num_trans: int = 2) -> dict:
    """Write the corpus under ``root`` (the annotations and the frame tree
    once, the seed's frames and features every call); returns its paths,
    each split's window count, the bytes of data written and the seconds
    taken."""
    t0 = time.perf_counter()
    counts = _layout(root, train_videos, val_videos, jpeg, temporal, gap,
                     num_trans)
    pixels, feats = (np.random.default_rng([seed, k]) for k in (1, 2))
    rgb = os.path.join(root, "rgb")
    feat_dir = os.path.join(root, "features")
    os.makedirs(feat_dir, exist_ok=True)
    out = {"rgb_data": rgb, "features_dir": feat_dir, "windows": {}}
    written = 0
    for split, name in SPLITS:
        csv_path = os.path.join(root, name)
        if jpeg:
            for vid in counts[split]:
                written += _fill_pool(os.path.join(rgb, vid), vid,
                                      _jpeg_pool(pixels))
        out[f"{split}_file"] = csv_path
        windows = ref_data.train_windows(
            ref_data.parse_csv(csv_path), counts[split], rgb,
            temporal=temporal, gap=gap, num_trans=num_trans)
        out["windows"][split] = len(windows)
        if features:
            arr = feats.standard_normal((len(windows), temporal, feat_dim),
                                        dtype=np.float32)
            np.save(os.path.join(feat_dir, f"features_{split}.npy"), arr)
            written += arr.nbytes
    out["bytes"] = written
    out["seconds"] = time.perf_counter() - t0
    return out
