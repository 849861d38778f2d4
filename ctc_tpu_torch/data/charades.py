"""Charades dataset: CSV parsing and window/target construction (port of
``ctc_tpu/data/charades.py``, numpy only).

The reference's default dataset ``charades_ctc_next_pred``; its skip, dedup
and balancing rules define the data distribution, so every quirk is kept,
and the port's output is held equal to ``ctc_tpu``'s
(``tests/test_torch_charades.py``):

* stride-100-frame sliding windows between the first label onset and the
  last label start;
* the verb CTC path keeps only *newly appearing* verbs per window,
  class-index encoded, -1 padded; the future label is NOT in the verb path;
* the object CTC path is multi-hot per transition time, deduplicated by a
  sum-of-2^o fingerprint that wraps at 32 bits (a row equal to any earlier
  row, or all-zero, is dropped), with the future-time row included;
* the future label = first label start strictly after the window; samples
  with none, with fewer than ``num_trans`` in-window transitions, or with
  paths longer than ``temporal`` are skipped;
* a global <=50-samples-per-future-verb balancing cap, accumulated in CSV
  order across the split;
* the ``val_video`` split takes 10 linspaced windows per video and builds
  the per-video (scene, object, verb) ground-truth table for mAP.

``cached_prepare`` pickles builtins and numpy only, so this package and
``ctc_tpu`` read each other's ``Charades_{split}.pkl``.
"""

from __future__ import annotations

import csv
import math
import os
import pickle
from glob import glob

import numpy as np

from ctc_tpu_torch.data.charades_classes import (
    CLASS_TO_OV,
    O_CLASSES,
    S_CLASSES,
    SCENE_TO_INT,
    V_CLASSES,
)

FPS = 24
STACK = 10
TEST_GAP = 10


def parse_charades_csv(filename: str, scene_to_int=None) -> dict:
    """CSV -> ``{vid: [{'scene', 'class', 'start', 'end'}, ...]}``
    (reference :15-36; class is the raw 'cXXX' string)."""
    scene_to_int = scene_to_int or SCENE_TO_INT
    labels = {}
    with open(filename) as f:
        for row in csv.DictReader(f):
            actions = []
            if row["actions"]:
                for a in row["actions"].split(";"):
                    cls, start, end = a.split(" ")
                    actions.append(
                        {
                            "scene": scene_to_int[row["scene"]],
                            "class": cls,
                            "start": float(start),
                            "end": float(end),
                        }
                    )
            labels[row["id"]] = actions
    return labels


def cls2int(x: str):
    """'c108' -> (object_id, verb_id) via the factorization table."""
    return CLASS_TO_OV[int(x[1:])]


def count_frames(rgb_root: str, vid: str) -> int:
    return len(glob(os.path.join(rgb_root, vid, "*.jpg")))


def prepare_windows(
    labels: dict,
    frame_counts: dict,
    split: str,
    temporal: int,
    gap: int,
    num_trans: int,
    rgb_root: str = "",
):
    """Build the sample set for one split.

    Args:
      labels: output of :func:`parse_charades_csv` (insertion order matters —
        the per-verb balancing cap accumulates in this order).
      frame_counts: ``{vid: #jpg frames}`` (injected for testability).
      split: 'train' | 'val' | 'val_video'.

    Returns:
      ``(data dict, gt_table)`` — data has the reference's keys
      (rgb_image_paths, o_targets, v_targets, s_targets, o_f_targets,
      v_f_targets, s_f_targets, ids, o_times, v_times, s_times).
    """
    adjust_time = temporal
    window_frames = temporal * (gap + 1) * STACK

    o_all = [0] * O_CLASSES
    v_all = [0] * V_CLASSES
    s_all = [0] * S_CLASSES

    out = {
        k: []
        for k in (
            "rgb_image_paths o_targets v_targets s_targets o_f_targets "
            "v_f_targets s_f_targets ids o_times v_times s_times".split()
        )
    }
    gt_table = {}

    for vid, label in labels.items():
        n_time = frame_counts.get(vid, 0) / FPS
        iddir = os.path.join(rgb_root, vid)

        start_time_series = []
        for x in label:
            if x["start"] < n_time and x["start"] not in start_time_series:
                start_time_series.append(x["start"])
        start_time_series.sort()
        if len(start_time_series) <= 1:
            continue

        time_series = []
        for x in label:
            if x["start"] < n_time and x["start"] not in time_series:
                time_series.append(x["start"])
            if x["end"] < n_time and x["end"] not in time_series:
                time_series.append(x["end"])
        time_series.sort()

        start_time = time_series[0]
        start_n = math.ceil(start_time * FPS)
        end_time = start_time_series[-1]
        end_n = int(end_time * FPS)
        if end_n - start_n < window_frames:
            continue

        if split == "val_video":
            if end_n - 1 - window_frames - 1 <= 0:
                continue
            locs = np.linspace(start_n, end_n - 1 - window_frames - 1, TEST_GAP)
            gt_label = []
            for loc in locs:
                sample = _build_window(
                    label, time_series, start_time_series, loc / FPS,
                    (loc + window_frames) / FPS, adjust_time, num_trans,
                    val_video=True, o_all=o_all, v_all=v_all, s_all=s_all,
                )
                if sample is None:
                    continue
                frame0 = int(np.floor(loc)) + 1
                paths = [
                    f"{iddir}/{vid}-{frame0 + t * (gap + 1) * STACK:06d}.jpg"
                    for t in range(temporal)
                ]
                _append(out, vid, paths, sample)
                for trip in sample["gt"]:
                    if trip not in gt_label:
                        gt_label.append(trip)
            gt_table[vid] = gt_label
        else:
            for ii in range(start_n, end_n - 1 - window_frames - 1, 100):
                sample = _build_window(
                    label, time_series, start_time_series, ii / FPS,
                    (ii + window_frames) / FPS, adjust_time, num_trans,
                    val_video=False, o_all=o_all, v_all=v_all, s_all=s_all,
                )
                if sample is None:
                    continue
                paths = [
                    f"{iddir}/{vid}-{ii + 1 + t * (gap + 1) * STACK:06d}.jpg"
                    for t in range(temporal)
                ]
                _append(out, vid, paths, sample)
    return out, gt_table


def _fingerprint(row):
    """Sum-of-2^i fingerprint with int32 WRAPAROUND.

    The reference accumulates ``2**o`` into a torch IntTensor
    (charades_ctc_next_pred.py:648-651), so for object ids >= 31 the powers
    overflow int32 and wrap — making some distinct rows collide (e.g. bit 32
    contributes 0 mod 2^32).  That overflow shapes the dedup'd data, so it is
    reproduced bit-for-bit here.
    """
    fp = 0
    for i, v in enumerate(row):
        fp += int(v) << i
    return fp & 0xFFFFFFFF


def _dedup_rows(target, adjust_time):
    """The reference's fingerprint dedup (:663-686): row t survives iff its
    sum-of-powers fingerprint differs from every entry of a positionally
    written array (zeros included — so empty rows never survive)."""
    fps = [0] * adjust_time
    kept = []
    for t in range(adjust_time):
        fp = _fingerprint(target[t])
        if fp not in fps:
            fps[t] = fp
            kept.append(np.array(target[t], dtype=np.int32))
    return kept


def _build_window(
    label, time_series, start_time_series, now, now_end, adjust_time,
    num_trans, *, val_video, o_all, v_all, s_all,
):
    time_in_series = []
    future_time = 0
    v_onehot = np.zeros((adjust_time,), np.int32)
    t_count = 0

    if val_video:
        for ts in time_series:
            if now <= ts <= now_end:
                time_in_series.append(ts)
    else:
        v_list = []
        for ts in time_series:
            if now <= ts <= now_end:
                new_flag = 0
                for x in label:
                    if x["start"] <= ts < x["end"]:
                        _, v = cls2int(x["class"])
                        if v not in v_list:
                            new_flag = 1
                            v_list.append(v)
                            v_onehot[t_count] = v
                if new_flag:
                    time_in_series.append(ts)
                    t_count += 1

    for st in start_time_series:
        if now_end < st:
            future_time = st
            time_in_series.append(st)
            break
    time_in_length = len(time_in_series)
    if future_time == 0:
        return None
    if not val_video and time_in_length - 1 < num_trans:
        return None
    if time_in_length > adjust_time:
        return None

    # future-accuracy targets (+ the train split's <=50-per-verb cap)
    o_f = np.zeros((O_CLASSES,), np.int32)
    v_f_multi = np.zeros((V_CLASSES,), np.int32)
    v_f = 0
    if val_video:
        for x in label:
            if x["start"] == future_time:
                o, v = cls2int(x["class"])
                o_f[o] = 1
                v_f_multi[v] = 1
    else:
        for x in label:
            if x["start"] == future_time:
                o, v = cls2int(x["class"])
                if v_all[v] > 50:
                    return None
                o_f[o] = 1
                v_f = v
                o_all[o] += 1
                v_all[v] += 1
    s_f = label[0]["scene"]
    if not val_video:
        s_all[s_f] += 1

    # CTC lattice targets (multi-hot per transition time, future row last)
    o_target = np.zeros((adjust_time, O_CLASSES), np.int32)
    v_target = np.zeros((adjust_time, V_CLASSES), np.int32)
    for t in range(time_in_length - 1):
        for x in label:
            if x["start"] <= time_in_series[t] < x["end"]:
                o, v = cls2int(x["class"])
                o_target[t, o] = 1
                v_target[t, v] = 1
    for x in label:
        if x["start"] == future_time:
            o, v = cls2int(x["class"])
            o_target[time_in_length - 1, o] = 1
            v_target[time_in_length - 1, v] = 1

    o_rows = _dedup_rows(o_target, adjust_time)
    v_rows = _dedup_rows(v_target, adjust_time)
    o_len, v_len = len(o_rows), len(v_rows)

    o_only = np.full((adjust_time, O_CLASSES), -1, np.int32)
    if o_rows:
        o_only[:o_len] = np.stack(o_rows)
    v_only = np.full((adjust_time, V_CLASSES), -1, np.int32)
    if v_rows:
        v_only[:v_len] = np.stack(v_rows)
    v_onehot[t_count:] = -1

    gt = []
    if val_video:
        for x in label:
            if x["start"] == future_time:
                o, v = cls2int(x["class"])
                if [s_f, o, v] not in gt:
                    gt.append([s_f, o, v])
    else:
        if o_len == 0 or v_len == 0:
            return None

    return {
        "o_target": o_only,
        "v_target": v_only if val_video else v_onehot,
        "s_target": s_f,
        "o_f": o_f,
        "v_f": v_f_multi if val_video else v_f,
        "s_f": s_f,
        "o_time": o_len,
        "v_time": v_len if val_video else t_count,
        "s_time": 1,
        "gt": gt,
    }


def _append(out, vid, paths, s):
    out["rgb_image_paths"].append(paths)
    out["o_targets"].append(s["o_target"])
    out["v_targets"].append(s["v_target"])
    out["s_targets"].append(s["s_target"])
    out["o_f_targets"].append(s["o_f"])
    out["v_f_targets"].append(s["v_f"])
    out["s_f_targets"].append(s["s_f"])
    out["ids"].append(vid)
    out["o_times"].append(s["o_time"])
    out["v_times"].append(s["v_time"])
    out["s_times"].append(s["s_time"])


def cached_prepare(cache_dir, split, *args, **kwargs):
    """Pickle-cached :func:`prepare_windows` (reference cache(), :68-83)."""
    os.makedirs(cache_dir, exist_ok=True)
    cachefile = os.path.join(cache_dir, f"Charades_{split}.pkl")
    if os.path.exists(cachefile):
        with open(cachefile, "rb") as f:
            return pickle.load(f)
    res = prepare_windows(*args, split=split, **kwargs)
    # renamed into place: the ranks of a data-parallel run on one host
    # may prepare the split at once, and none may read a partial file
    tmp = f"{cachefile}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        pickle.dump(res, f)
    os.replace(tmp, cachefile)
    return res
