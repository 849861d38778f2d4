"""A Charades-format corpus made from a seed: annotation CSVs, frame
directories and cached feature files, for runs of the Charades loaders
where the real corpus is not on the machine.  ``ctc_tpu`` has no
counterpart; its loaders read what this writes just as the port's do.

What it writes under ``root``:

* ``Charades_v1_train.csv`` and ``Charades_v1_test.csv`` with the real
  columns; each video has a scene of ``SCENE_TO_INT``, a length in seconds
  and ``cXXX start end`` actions of uniformly drawn classes, drawn so that
  their means are Charades' published ones (``PUBLISHED``): videos of
  30 s, 6.75 actions a video, actions of 12.8 s (two decimals, as in the
  real files).  Only the means are published; the shapes are this
  module's: a video's length uniform on [24, 36] s, its action count
  1 + Poisson(5.75), an action's length uniform on [6.4, 19.2] s and its
  start uniform over the video, so that it ends inside it.  Actions
  overlap, as in the real corpus;
* ``rgb/<vid>/<vid>-NNNNNN.jpg``: frames at 24 fps over the whole video.
  By default they are empty, which is all the feature loaders read of them
  (they count them).  With ``jpeg=True`` they decode, for the pixels path
  and feature extraction: each video has a pool of ``JPEG_POOL`` smooth
  seeded ``JPEG_SIZE`` images (shorter side 288 > 256, so the loaders'
  resize and their 224 crop both do work), and frame j is image
  ``(j - 1) % JPEG_POOL``, so a gap-strided stack cycles through them;
* ``features/<key>_<split>.npy``: ``[N, 10, feat_dim]`` float32 normals per
  loader and split, ``N`` from the port's own ``prepare_*`` at the
  reference preset's geometry (``--temporal 10 --gap 2 --num-trans 2``),
  under the names the loaders open (``--features-dir``).

Only the scale is cut: 240 train and 56 test videos by default, against
the published 7985 and 1863 (the same ratio).  Run: ``python -m
ctc_tpu_torch.data.charades_corpus DIR [--seed S] [--train-videos N]
[--val-videos N] [--feat-dim F] [--jpeg]``; it prints one JSON line with
the paths and sample counts.
"""

from __future__ import annotations

import argparse
import io
import json
import math
import os

import numpy as np

from ctc_tpu_torch.data import charades, charades_variants
from ctc_tpu_torch.data.charades_classes import C_CLASSES, SCENE_TO_INT

#: the reference preset's (temporal, gap, num_trans), ``cli.exe.PRESET``
GEOMETRY = (10, 2, 2)
#: Charades' published means (Sigurdsson et al., "Hollywood in Homes:
#: Crowdsourcing Data Collection for Activity Understanding", ECCV 2016):
#: 9848 videos of about 30 s, 7985 train and 1863 test, with 66500
#: temporal action intervals over 157 classes (6.75 a video) of 12.8 s on
#: average
PUBLISHED = {"video_s": 30.0, "actions": 66500 / 9848, "action_s": 12.8}
#: decodable frames (``jpeg=True``): (width, height), images a video, and
#: the JPEG quality
JPEG_SIZE = (384, 288)
JPEG_POOL = 8
JPEG_QUALITY = 90
HEADER = ("id,subject,scene,quality,relevance,verified,script,objects,"
          "descriptions,actions,length\n")


def _video(rng, vid):
    """One CSV row (as a string) and the video's frame count."""
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
    return row, math.ceil(length * charades.FPS)


def _jpeg_pool(rng) -> list[bytes]:
    """``JPEG_POOL`` encoded smooth images: random 12 x 9 colour grids
    resized bilinearly to ``JPEG_SIZE``."""
    from PIL import Image

    pool = []
    for _ in range(JPEG_POOL):
        grid = rng.integers(0, 256, (9, 12, 3), dtype=np.uint8)
        img = Image.fromarray(grid).resize(JPEG_SIZE, Image.BILINEAR)
        buf = io.BytesIO()
        img.save(buf, format="JPEG", quality=JPEG_QUALITY)
        pool.append(buf.getvalue())
    return pool


def _split_sizes(labels, counts, temporal, gap, num_trans, split):
    """``{feature file stem: N}`` of one CSV for every loader."""
    v = charades_variants
    sizes = {}
    for sub in ((split, "val_video") if split == "val" else (split,)):
        data, _ = charades.prepare_windows(labels, counts, sub, temporal,
                                           gap, num_trans)
        sizes[f"features_{sub}"] = len(data["ids"])
    v1 = v.prepare_v1(labels, counts, temporal, gap)
    sizes[f"features_v1_{split}"] = sum(int(t) >= 2 for t in v1["times"])
    sizes[f"features_ver2_{split}"] = len(
        v.prepare_ver2(labels, counts, temporal, gap, num_trans)["ids"])
    sizes[f"features_ver3_{split}"] = len(
        v.prepare_ver3(labels, counts, split, temporal, gap,
                       num_trans)["ids"])
    sizes[f"features_cclass_{split}"] = len(
        v.prepare_c_class(labels, counts, split, temporal, gap)["ids"])
    return sizes


def write_corpus(root, *, seed: int = 0, train_videos: int = 240,
                 val_videos: int = 56, feat_dim: int = 1024,
                 jpeg: bool = False) -> dict:
    """Write the corpus under ``root`` (decodable frames with ``jpeg``);
    returns its paths and ``{"samples": {feature file stem: N}}``."""
    # one stream for the annotations, one for the features and one for the
    # frames, so the CSVs depend on neither feat_dim nor jpeg
    rng, feat_rng, jpeg_rng = (np.random.default_rng([seed, k])
                               for k in (0, 1, 2))
    temporal = GEOMETRY[0]
    rgb = os.path.join(root, "rgb")
    features = os.path.join(root, "features")
    os.makedirs(features, exist_ok=True)
    out = {"rgb_data": rgb, "features_dir": features, "samples": {}}
    for split, n_videos, name in (
        ("train", train_videos, "Charades_v1_train.csv"),
        ("val", val_videos, "Charades_v1_test.csv"),
    ):
        csv_path = os.path.join(root, name)
        counts = {}
        with open(csv_path, "w") as f:
            f.write(HEADER)
            for i in range(n_videos):
                vid = f"{split[0].upper()}{i:04d}"
                row, counts[vid] = _video(rng, vid)
                f.write(row)
        for vid, n in counts.items():
            d = os.path.join(rgb, vid)
            os.makedirs(d, exist_ok=True)
            pool = _jpeg_pool(jpeg_rng) if jpeg else [b""]
            for j in range(1, n + 1):
                with open(os.path.join(d, f"{vid}-{j:06d}.jpg"), "wb") as f:
                    f.write(pool[(j - 1) % len(pool)])
        out[f"{split}_file"] = csv_path
        labels = charades.parse_charades_csv(csv_path)
        sizes = _split_sizes(labels, counts, *GEOMETRY, split)
        for stem, n in sizes.items():
            feats = feat_rng.standard_normal((n, temporal, feat_dim),
                                             dtype=np.float32)
            np.save(os.path.join(features, f"{stem}.npy"), feats)
        out["samples"].update(sizes)
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("root")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--train-videos", type=int, default=240)
    parser.add_argument("--val-videos", type=int, default=56)
    parser.add_argument("--feat-dim", type=int, default=1024)
    parser.add_argument("--jpeg", action="store_true",
                        help="decodable seeded JPEG frames")
    a = parser.parse_args(argv)
    out = write_corpus(a.root, seed=a.seed, train_videos=a.train_videos,
                       val_videos=a.val_videos, feat_dim=a.feat_dim,
                       jpeg=a.jpeg)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
