"""Charades loader: CSV + frame dirs -> cached windows -> cached I3D
features -> collated batches (port of
``ctc_tpu/data/loaders/charades_ctc_next_pred.py``; the reference's default
train/val dataset).

Feature source (``_common.split_features`` with the key ``features``),
``[N, T, F]`` per prepared split:

1. ``cfg.features_dir``: ``features_{split}.npy`` and
   ``features_val_video.npy``;
2. ``cfg.rgb_pretrained_weights``: an I3D checkpoint in the reference's
   key layout, run frozen over the JPEG windows on ``cfg.device`` and
   cached under ``<cache>/features_<split>``;
3. a randomly initialized I3D (from seed 0; smoke runs only), with a
   WARNING line.

The collate follows ``--loss``: the verb path, the multi-hot object path
(``binary``) or both (``joint``).
"""

from __future__ import annotations

import numpy as np
import torch

from ctc_tpu_torch.data import charades
from ctc_tpu_torch.data.features import I3DFeatureExtractor
from ctc_tpu_torch.data.loaders._common import (
    shard_and_collate,
    split_features,
)
from ctc_tpu_torch.data.loading import (
    collate_binary_ctc,
    collate_joint_ctc,
    collate_verb_ctc,
)
from ctc_tpu_torch.models.i3d import InceptionI3d, without_logits


def _extractor(cfg):
    """The frozen I3D feature extractor on ``cfg.device``: the
    ``--rgb-pretrained-weights`` checkpoint, else random weights."""
    model = InceptionI3d(num_classes=None)
    if cfg.rgb_pretrained_weights:
        model.load_state_dict(without_logits(torch.load(
            cfg.rgb_pretrained_weights, map_location="cpu")))
    else:
        print(
            "WARNING: --rgb-pretrained-weights not set — extracting "
            "features with a RANDOMLY INITIALIZED I3D backbone. This is "
            "only meaningful for smoke runs; real training needs the "
            "Kinetics checkpoint (reference models/__init__.py:29-31).",
            flush=True,
        )
        model.reset_parameters(torch.Generator().manual_seed(0))
    return I3DFeatureExtractor(model, device=cfg.device)


def _prepared(cfg, split, csv_file):
    labels = charades.parse_charades_csv(csv_file)
    frame_counts = {
        vid: charades.count_frames(cfg.rgb_data, vid) for vid in labels
    }
    return charades.cached_prepare(
        cfg.cache, split, labels, frame_counts,
        temporal=cfg.temporal, gap=cfg.gap, num_trans=cfg.num_trans,
        rgb_root=cfg.rgb_data,
    )


def _split_batches(cfg, split, csv_file, collate):
    data, _ = _prepared(cfg, split, csv_file)
    if len(data["ids"]) == 0:
        return []
    feats = split_features(cfg, data, "features", split)
    return shard_and_collate(cfg, data, feats, split, collate)


def get(cfg):
    collate = {
        "binary": collate_binary_ctc,
        "joint": collate_joint_ctc,
    }.get(cfg.loss, collate_verb_ctc)
    train = _split_batches(cfg, "train", cfg.train_file, collate)
    val = _split_batches(cfg, "val", cfg.val_file, collate)
    return train, val


def get_val_video(cfg):
    """val_video split: per-video linspaced windows + gt_table + features
    (the reference's valvideo_loader + gt_table pair), for video-level
    evaluation (ROADMAP Queue 1 item 10)."""
    data, gt_table = _prepared(cfg, "val_video", cfg.val_file)
    if len(data["ids"]) == 0:
        return data, gt_table
    data["features"] = np.asarray(
        split_features(cfg, data, "features", "val_video"))
    return data, gt_table
