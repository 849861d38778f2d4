"""The reference's dataset-variant family (port of
``ctc_tpu/data/charades_variants.py``, numpy only): the functions that
build each importable variant's windows and targets:

* :func:`prepare_v1`        — datasets/charades.py (whole-video recognition,
  variable-length multi-hot o/v interval series, no future label).
* :func:`prepare_ver2`      — datasets/charades_ver2.py (first-window-only CTC
  + prediction: multi-hot o/v paths with -1 padding, future label included).
* :func:`prepare_ver2_groundtruth` / :func:`prepare_ver2_future_groundtruth`
  — the gt lookup tables (charades_ver2.py:353-412 / :296-349).
* :func:`prepare_ver3`      — datasets/charades_ver3.py (single future-time
  multi-hot o/v CE target; non-train splits drop the last sample).
* :func:`prepare_c_class`   — datasets/charades_ver2_c_class.py (157-class
  index path for standard blank CTC, start-time-overwrite rule).
* :func:`prepare_my_pred`   — datasets/charades_my_pred.py (own-video eval at
  FPS 29.94, dense stride-1 windows; includes its frames-vs-seconds
  ``now_end`` comparison quirk, kept as-is).
* :func:`prepare_myvideo` / :func:`prepare_myvideo_ver3` /
  :func:`prepare_myvideo_c_class` — the own-video twins (FPS 29.94).
* :data:`MYVIDEO_LABELS` — the hardcoded own-video label dict
  (charades_my_pred.py:372-383).

Each is held equal to ``ctc_tpu``'s on the same CSV and frame counts
(``tests/test_torch_charades.py``).
"""

from __future__ import annotations

import math

import numpy as np

from ctc_tpu_torch.data.charades import FPS, STACK, cls2int
from ctc_tpu_torch.data.charades_classes import O_CLASSES, V_CLASSES

MY_FPS = 29.94

# The reference's hardcoded own-video labels (walk/stand/sit transitions).
MYVIDEO_LABELS = {
    "YUME0": [
        {"scene": 11, "class": "c097", "start": 0, "end": 3.0},
        {"scene": 11, "class": "c060", "start": 3.0, "end": 4.0},
        {"scene": 11, "class": "c059", "start": 4.0, "end": 8.0},
        {"scene": 11, "class": "c060", "start": 8.0, "end": 12.0},
        {"scene": 11, "class": "c097", "start": 12.0, "end": 15.0},
    ]
}


def _time_series(label, *, ends=True, n_time=None):
    out = []
    for x in label:
        for key in ("start", "end") if ends else ("start",):
            t = x[key]
            if (n_time is None or t < n_time) and t not in out:
                out.append(t)
    out.sort()
    return out


def _paths(rgb_root, vid, temporal, gap, first_frame):
    return [
        f"{rgb_root}/{vid}/{vid}-{first_frame + t * (gap + 1) * STACK:06d}.jpg"
        for t in range(temporal)
    ]


# --------------------------------------------------------------- charades v1


def prepare_v1(labels, frame_counts, temporal, gap, rgb_root=""):
    out = {k: [] for k in
           "rgb_image_paths s_targets o_targets v_targets ids times".split()}
    for vid, label in labels.items():
        n = frame_counts.get(vid, 0)
        ts = _time_series(label)
        time_length = len(ts)
        if n == 0 or time_length == 0:
            continue
        out["rgb_image_paths"].append(_paths(rgb_root, vid, temporal, gap, 1))
        o_target = np.zeros((time_length - 1, O_CLASSES), np.int32)
        v_target = np.zeros((time_length - 1, V_CLASSES), np.int32)
        s_target = np.zeros((time_length - 1,), np.int32)
        for t in range(time_length - 1):
            for x in label:
                if x["start"] <= ts[t] and x["end"] >= ts[t + 1]:
                    o, v = cls2int(x["class"])
                    o_target[t, o] = 1
                    v_target[t, v] = 1
                s_target[t] = x["scene"]
        out["s_targets"].append(s_target)
        out["o_targets"].append(o_target)
        out["v_targets"].append(v_target)
        out["ids"].append(vid)
        out["times"].append(time_length)
    return out


# --------------------------------------------------------------- ver2 family


def _ver2_select(label, temporal, gap):
    """Shared ver2/ver3 selection: all starts+ends, first window, first label
    past the window end becomes the future (charades_ver2.py:455-484)."""
    ts = _time_series(label)
    if not ts:
        return None
    start_time = ts[0]
    end_time = start_time + temporal * (gap + 1) * STACK / FPS
    future_time = 0
    time_in = []
    for t in ts:
        if t <= end_time:
            time_in.append(t)
        if t > end_time:
            future_time = t
            time_in.append(t)
            break
    return ts, start_time, end_time, future_time, time_in


def prepare_ver2(labels, frame_counts, temporal, gap, num_trans, rgb_root=""):
    adjust_time = temporal
    out = {k: [] for k in
           "rgb_image_paths o_targets v_targets s_targets ids times".split()}
    for vid, label in labels.items():
        n = frame_counts.get(vid, 0)
        sel = _ver2_select(label, temporal, gap)
        if sel is None:
            continue
        ts, start_time, _, future_time, time_in = sel
        if n < start_time * FPS + temporal * (gap + 1) * STACK + 1:
            continue
        time_in_length = len(time_in)
        if future_time == 0 or time_in_length - 1 < num_trans:
            continue
        if time_in_length > adjust_time:
            continue
        out["rgb_image_paths"].append(
            _paths(rgb_root, vid, temporal, gap,
                   math.floor(start_time * FPS) + 1)
        )
        o_target = np.zeros((adjust_time, O_CLASSES), np.int32)
        v_target = np.zeros((adjust_time, V_CLASSES), np.int32)
        s_target = np.zeros((adjust_time,), np.int32)
        for t in range(time_in_length):
            for x in label:
                if x["start"] <= time_in[t] <= x["end"]:
                    o, v = cls2int(x["class"])
                    o_target[t, o] = 1
                    v_target[t, v] = 1
                s_target[t] = label[0]["scene"]
        o_target[time_in_length:] = -1
        v_target[time_in_length:] = -1
        out["o_targets"].append(o_target)
        out["v_targets"].append(v_target)
        out["s_targets"].append(s_target)
        out["ids"].append(vid)
        out["times"].append(time_in_length)
    return out


def prepare_ver2_groundtruth(labels, temporal, gap, num_trans):
    gt_table = {}
    for vid, label in labels.items():
        sel = _ver2_select(label, temporal, gap)
        if sel is None:
            continue
        _, _, _, future_time, time_in = sel
        time_in_length = len(time_in)
        if future_time == 0 or time_in_length - 1 < num_trans:
            continue
        if time_in_length > temporal:
            continue
        gt = []
        s = label[0]["scene"]
        for t in range(time_in_length):
            for x in label:
                if x["start"] <= time_in[t] <= x["end"]:
                    o, v = cls2int(x["class"])
                    if [s, o, v] not in gt:
                        gt.append([s, o, v])
        gt_table[vid] = gt
    return gt_table


def prepare_ver2_future_groundtruth(labels, temporal, gap):
    gt_table = {}
    for vid, label in labels.items():
        ts = _time_series(label)
        if not ts:
            continue
        start_time = ts[0]
        limit = start_time + temporal * STACK * (gap + 1) / FPS
        adjust_series = []
        future_time = 0
        for t in ts:
            if t > limit:
                future_time = t
                break
            adjust_series.append(t)
        if future_time == 0:
            continue
        gt = []
        s = label[0]["scene"]
        # reference quirk: the future labels repeat once per in-window time
        for _ in range(len(adjust_series)):
            for x in label:
                if x["start"] == future_time:
                    o, v = cls2int(x["class"])
                    gt.append([s, o, v])
        gt_table[vid] = gt
    return gt_table


def prepare_ver3(labels, frame_counts, split, temporal, gap, num_trans,
                 rgb_root=""):
    out = {k: [] for k in
           "rgb_image_paths o_targets v_targets s_targets ids times".split()}
    for vid, label in labels.items():
        n = frame_counts.get(vid, 0)
        sel = _ver2_select(label, temporal, gap)
        if sel is None:
            continue
        ts, start_time, _, future_time, time_in = sel
        if n < start_time * FPS + temporal * STACK * (gap + 1) + 1:
            continue
        time_in_length = len(time_in)
        if future_time == 0 or time_in_length - 1 < num_trans:
            continue
        if time_in_length > temporal:
            continue
        out["rgb_image_paths"].append(
            _paths(rgb_root, vid, temporal, gap,
                   math.floor(start_time * FPS) + 1)
        )
        o_target = np.zeros((O_CLASSES,), np.int32)
        v_target = np.zeros((V_CLASSES,), np.int32)
        for x in label:
            if x["start"] <= future_time <= x["end"]:
                o, v = cls2int(x["class"])
                o_target[o] = 1
                v_target[v] = 1
        out["o_targets"].append(o_target)
        out["v_targets"].append(v_target)
        out["s_targets"].append(label[0]["scene"])
        out["ids"].append(vid)
        out["times"].append(len(ts))
    if split != "train":
        out = {k: v[:-1] for k, v in out.items()}
    return out


def prepare_c_class(labels, frame_counts, split, temporal, gap, rgb_root=""):
    adjust_time = temporal
    limit = STACK * (gap + 1) * temporal / FPS
    out = {k: [] for k in
           "rgb_image_paths s_targets c_targets ids times".split()}
    for vid, label in labels.items():
        n = frame_counts.get(vid, 0)
        if n < STACK * (gap + 1) * temporal:
            continue
        ts = _time_series(label, ends=False)
        time_length = len(ts)
        if n == 0 or time_length < 3:
            continue
        time_limit = []
        for t in ts:
            time_limit.append(t)
            if t > limit:
                break
        if time_limit[-1] < limit:  # no future label inside
            continue
        out["rgb_image_paths"].append(_paths(rgb_root, vid, temporal, gap, 1))
        c_target = np.zeros((adjust_time,), np.int32)
        for t in range(min(len(time_limit), adjust_time)):
            for x in label:
                if x["start"] == time_limit[t]:
                    c_target[t] = int(x["class"][1:])
        # reference quirk: padding keyed on time_length, not len(time_limit)
        if time_length < adjust_time:
            c_target[time_length:] = -1
        out["s_targets"].append(label[0]["scene"])
        out["c_targets"].append(c_target)
        out["ids"].append(vid)
        out["times"].append(min(time_length, adjust_time))
    if split != "train":
        out = {k: v[:-1] for k, v in out.items()}
    return out


# ------------------------------------------------------------ my-video twins


def prepare_my_pred(labels, frame_counts, temporal, gap, rgb_root=""):
    """Dense stride-1 own-video windows (charades_my_pred.py:390-490).

    Keeps the reference's frames-vs-seconds ``now_end`` comparison: the window
    end is in FRAMES while times are in seconds, so the in-window test is
    effectively ``ts >= now`` — reproduced, not fixed.
    """
    adjust_time = temporal
    out = {k: [] for k in
           "rgb_image_paths o_targets v_targets s_targets ids times".split()}
    for vid, label in labels.items():
        n = frame_counts.get(vid, 0)
        n_time = n / MY_FPS
        ts = _time_series(label, n_time=n_time)
        time_length = len(ts)
        if time_length < 3:
            continue
        start_n = math.ceil(ts[0] * MY_FPS)
        end_n = n
        end_time = n_time
        for ii in range(start_n, end_n - 1 - temporal * (gap + 1) * STACK - 1):
            now = ii / MY_FPS
            now_end = ii + temporal * (gap + 1) * STACK  # frames (quirk)
            time_in = []
            future_time = 0
            for t in ts:
                if now <= t < now_end:
                    time_in.append(t)
                if t > end_time:
                    future_time = t
                    time_in.append(t)
                    break
            time_in_length = len(time_in)
            o_target = np.zeros((adjust_time, O_CLASSES), np.int32)
            v_target = np.zeros((adjust_time, V_CLASSES), np.int32)
            s_target = np.zeros((adjust_time,), np.int32)
            for t in range(time_in_length):
                for x in label:
                    if x["start"] <= time_in[t] <= x["end"]:
                        o, v = cls2int(x["class"])
                        o_target[t, o] = 1
                        v_target[t, v] = 1
                    s_target[t] = label[0]["scene"]
            o_target[time_in_length:] = -1
            v_target[time_in_length:] = -1
            out["rgb_image_paths"].append(
                _paths(rgb_root, vid, temporal, gap, ii + 1)
            )
            out["o_targets"].append(o_target)
            out["v_targets"].append(v_target)
            out["s_targets"].append(s_target)
            out["ids"].append(vid)
            out["times"].append(time_in_length)
    return out


def prepare_myvideo(labels, frame_counts, temporal, gap, rgb_root=""):
    """Start-time class-index o/v paths padded to the corpus max length
    (myvideo.py:296-449; labels are +1-shifted for the blank slot)."""
    max_length = max(
        (len(_time_series(l, ends=False)) for l in labels.values()), default=0
    )
    adjust_time = max_length
    out = {k: [] for k in
           "rgb_image_paths s_targets o_targets v_targets ids times".split()}
    for vid, label in labels.items():
        n = frame_counts.get(vid, 0)
        if n < (10 + gap) * temporal:
            continue
        ts = _time_series(label, ends=False)
        time_length = len(ts)
        if n == 0 or time_length == 0:
            continue
        out["rgb_image_paths"].append(_paths(rgb_root, vid, temporal, gap, 1))
        o_target = np.zeros((adjust_time,), np.int32)
        v_target = np.zeros((adjust_time,), np.int32)
        for t in range(min(time_length, adjust_time)):
            for x in label:
                if x["start"] == ts[t]:
                    o, v = cls2int(x["class"])
                    o_target[t] = o + 1
                    v_target[t] = v + 1
        out["s_targets"].append(np.array([label[0]["scene"] + 1], np.int32))
        out["o_targets"].append(o_target)
        out["v_targets"].append(v_target)
        out["ids"].append(vid)
        out["times"].append(min(time_length, 8))
    return out


def prepare_myvideo_ver3(labels, frame_counts, temporal, gap, rgb_root=""):
    """Current-time o/v single-label targets on a fixed time grid
    (myvideo_ver3.py:300-402)."""
    out = {k: [] for k in
           "rgb_image_paths o_targets v_targets ids times".split()}
    for vid, label in labels.items():
        n = frame_counts.get(vid, 0)
        if n < temporal * STACK * (gap + 1):
            continue
        ts = [t * STACK * (gap + 1) / MY_FPS for t in range(temporal)]
        out["rgb_image_paths"].append(_paths(rgb_root, vid, temporal, gap, 1))
        o_target = np.zeros((temporal,), np.int32)
        v_target = np.zeros((temporal,), np.int32)
        for t in range(temporal):
            for x in label:
                if x["start"] <= ts[t] <= x["end"]:
                    o, v = cls2int(x["class"])
                    o_target[t] = o
                    v_target[t] = v
        out["o_targets"].append(o_target)
        out["v_targets"].append(v_target)
        out["ids"].append(vid)
        out["times"].append(temporal)
    return out


def prepare_myvideo_c_class(labels, frame_counts, temporal, gap, rgb_root=""):
    """157-class start-time index paths, adjust_time=4, frames offset by 50
    (myvideo_c_class.py:298-443)."""
    adjust_time = 4
    out = {k: [] for k in
           "rgb_image_paths s_targets c_targets ids times".split()}
    for vid, label in labels.items():
        n = frame_counts.get(vid, 0)
        if n < (10 + gap) * temporal:
            continue
        ts = _time_series(label, ends=False)
        time_length = len(ts)
        if n == 0 or time_length == 0:
            continue
        out["rgb_image_paths"].append(_paths(rgb_root, vid, temporal, gap, 51))
        c_target = np.zeros((adjust_time,), np.int32)
        for t in range(min(time_length, adjust_time)):
            for x in label:
                if x["start"] == ts[t]:
                    c_target[t] = int(x["class"][1:])
        if time_length < adjust_time:
            c_target[time_length:] = -1
        out["s_targets"].append(np.array([label[0]["scene"]], np.int32))
        out["c_targets"].append(c_target)
        out["ids"].append(vid)
        out["times"].append(min(time_length, adjust_time))
    return out
