"""The reference's data layer: Charades CSV -> training windows -> batches.

A frozen copy of the published training recipe's data rules (the reference
repository's ``charades_ctc_next_pred`` loader) for the train split, in
plain numpy, and the torchvision frame pipeline in PIL.  It imports nothing
of the program: the harness holds the program's batches against what this
works out again from the same corpus files.

* windows slide by 100 frames between the first label onset and the last
  label start, each ``temporal * (gap + 1) * STACK`` frames long;
* the verb path keeps only newly appearing verbs, class-index encoded and
  -1 padded; the future label is the first label start after the window;
* a window with no future label, fewer than ``num_trans`` in-window
  transitions or a path longer than ``temporal`` is skipped, as is one
  whose future verb has been seen more than 50 times (in CSV order);
* the object path's rows are deduplicated by a sum-of-2^o fingerprint that
  wraps at 32 bits, and a window whose object or verb path comes out empty
  is skipped;
* the train batches are a seeded shuffle (``numpy.random.default_rng``)
  cut into full batches;
* a step's clip is the frames at the model's offsets from the step's
  anchor frame (``clip_offsets`` of its reference module);
* a frame is decoded, its shorter side resized to ``256 / 224 * inputsize``
  bilinearly, centre-cropped to ``inputsize`` and mapped to ``[-1, 1]``.
"""

from __future__ import annotations

import csv
import math
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from benchmark.reference.classes import (
    CLASS_TO_OV,
    O_CLASSES,
    SCENE_TO_INT,
    V_CLASSES,
)

FPS = 24
STACK = 10


def parse_rows(lines) -> dict:
    """``{vid: [{"scene", "class", "start", "end"}, ...]}`` of CSV lines
    (the header first), in their order."""
    labels = {}
    for row in csv.DictReader(lines):
        actions = []
        for a in filter(None, row["actions"].split(";")):
            cls, start, end = a.split(" ")
            actions.append({"scene": SCENE_TO_INT[row["scene"]],
                            "class": int(cls[1:]),
                            "start": float(start), "end": float(end)})
        labels[row["id"]] = actions
    return labels


def parse_csv(path: str) -> dict:
    with open(path) as f:
        return parse_rows(f)


def count_frames(rgb_root: str, vid: str) -> int:
    d = os.path.join(rgb_root, vid)
    return sum(1 for n in os.listdir(d) if n.endswith(".jpg"))


def _fingerprint(row) -> int:
    return sum(int(v) << i for i, v in enumerate(row)) & 0xFFFFFFFF


def _dedup_len(target) -> int:
    """Rows of ``target`` that survive the positional fingerprint dedup."""
    fps = [0] * len(target)
    kept = 0
    for t, row in enumerate(target):
        fp = _fingerprint(row)
        if fp not in fps:
            fps[t] = fp
            kept += 1
    return kept


def _window(label, times, starts, now, now_end, temporal, num_trans,
            v_seen):
    """``(verb path, verb path length, future verb)`` of one train window,
    or None where the rules skip it."""
    in_window, verbs = [], []
    path = np.zeros((temporal,), np.int64)
    for ts in times:
        if not now <= ts <= now_end:
            continue
        new = False
        for x in label:
            if x["start"] <= ts < x["end"]:
                v = CLASS_TO_OV[x["class"]][1]
                if v not in verbs:
                    # one path entry a transition time: its last new verb
                    new = True
                    verbs.append(v)
                    path[len(in_window)] = v
        if new:
            in_window.append(ts)
    path[len(in_window):] = -1
    length = len(in_window)
    future = next((st for st in starts if now_end < st), 0)
    if future == 0:
        return None
    in_window.append(future)
    n = len(in_window)
    if n - 1 < num_trans or n > temporal:
        return None
    future_verb = 0
    for x in label:
        if x["start"] == future:
            o, v = CLASS_TO_OV[x["class"]]
            if v_seen[v] > 50:
                return None
            future_verb = v
            v_seen[v] += 1
    o_t = np.zeros((temporal, O_CLASSES), np.int64)
    v_t = np.zeros((temporal, V_CLASSES), np.int64)
    for t in range(n - 1):
        for x in label:
            if x["start"] <= in_window[t] < x["end"]:
                o, v = CLASS_TO_OV[x["class"]]
                o_t[t, o] = v_t[t, v] = 1
    for x in label:
        if x["start"] == future:
            o, v = CLASS_TO_OV[x["class"]]
            o_t[n - 1, o] = v_t[n - 1, v] = 1
    if _dedup_len(o_t) == 0 or _dedup_len(v_t) == 0:
        return None
    return path, length, future_verb


def train_windows(labels: dict, frame_counts: dict, rgb_root: str, *,
                  temporal: int, gap: int, num_trans: int) -> list[dict]:
    """The train split's windows in CSV order: each ``{"frames": [temporal]
    anchor frame paths, "path", "length", "future"}``."""
    window_frames = temporal * (gap + 1) * STACK
    v_seen = [0] * V_CLASSES
    out = []
    for vid, label in labels.items():
        n_time = frame_counts.get(vid, 0) / FPS
        starts = sorted({x["start"] for x in label if x["start"] < n_time})
        if len(starts) <= 1:
            continue
        times = sorted({x["start"] for x in label if x["start"] < n_time}
                       | {x["end"] for x in label if x["end"] < n_time})
        start_n = math.ceil(times[0] * FPS)
        end_n = int(starts[-1] * FPS)
        if end_n - start_n < window_frames:
            continue
        for ii in range(start_n, end_n - 1 - window_frames - 1, 100):
            w = _window(label, times, starts, ii / FPS,
                        (ii + window_frames) / FPS, temporal, num_trans,
                        v_seen)
            if w is None:
                continue
            frames = [os.path.join(rgb_root, vid,
                                   f"{vid}-{ii + 1 + t * (gap + 1) * STACK:06d}.jpg")
                      for t in range(temporal)]
            out.append({"frames": frames, "path": w[0], "length": w[1],
                        "future": w[2]})
    return out


def train_batches(n: int, batch_size: int, seed: int) -> list:
    """Index batches of the seeded shuffle; a short last batch is dropped."""
    order = np.arange(n)
    np.random.default_rng(seed).shuffle(order)
    return [order[i:i + batch_size]
            for i in range(0, n - batch_size + 1, batch_size)]


def load_frame(path: str, inputsize: int) -> np.ndarray:
    """One JPEG -> ``[inputsize, inputsize, 3]`` float32 in [-1, 1]."""
    from PIL import Image

    with open(path, "rb") as f:
        img = Image.open(f).convert("RGB")
    target = int(256.0 / 224 * inputsize)
    w, h = img.size
    if w < h:
        size = (target, int(round(h * target / w)))
    else:
        size = (int(round(w * target / h)), target)
    img = img.resize(size, Image.BILINEAR)
    left, top = (size[0] - inputsize) // 2, (size[1] - inputsize) // 2
    img = img.crop((left, top, left + inputsize, top + inputsize))
    return (np.asarray(img, np.float32) / 255.0 - 0.5) / 0.5


def window_clips(anchors, offsets, inputsize: int,
                 threads: int = 8) -> np.ndarray:
    """``[T]`` anchor frame paths -> ``[T, len(offsets), h, w, 3]``
    float32: each anchor's clip, the frames ``offsets`` after it (the
    model's ``clip_offsets``)."""
    paths = []
    for p in anchors:
        base, first = p[:-10], int(p[-10:-4])
        paths += [f"{base}{first + o:06d}.jpg" for o in offsets]
    with ThreadPoolExecutor(threads) as pool:
        frames = list(pool.map(lambda p: load_frame(p, inputsize), paths))
    return np.stack(frames).reshape(len(anchors), len(offsets), inputsize,
                                    inputsize, 3)
