"""Loader for the v1 recognition dataset, ``--dataset charades`` (port of
``ctc_tpu/data/loaders/charades.py``).

The earliest reference variant: whole-video label-interval series with
*variable-length* multi-hot o/v paths (``time_length - 1`` steps, no future
label, no padding).  Batches pad the paths to the longest in the batch and
train with ``--loss binary`` (multi-hot emissions); the per-sample true
length rides in ``target_lengths`` like the reference's ``meta`` lengths.

Videos with fewer than two label timestamps would yield an EMPTY path
(``time_length - 1 == 0``); the reference never batches those (its default
collate cannot stack variable lengths at all), so they are filtered out
rather than fabricating a zero-length lattice.
"""

from __future__ import annotations

import numpy as np

from ctc_tpu_torch.data.charades_variants import prepare_v1
from ctc_tpu_torch.data.loaders._common import filter_samples, split_batches


def collate_v1(data: dict, indices, features: np.ndarray) -> dict:
    """Pad the variable-length multi-hot o paths to the batch max."""
    idx = list(indices)
    lengths = [max(int(data["times"][i]) - 1, 1) for i in idx]
    max_l = max(lengths)
    n_cls = np.asarray(data["o_targets"][idx[0]]).shape[-1]
    paths = np.zeros((len(idx), max_l, n_cls), np.float32)
    for row, i in enumerate(idx):
        o = np.asarray(data["o_targets"][i], np.float32)
        paths[row, : o.shape[0]] = np.clip(o, 0.0, 1.0)
    temporal = features.shape[1]
    # no future label in v1: score the last attained path step instead
    future = np.asarray(
        [int(np.argmax(paths[row, lengths[row] - 1]))
         for row in range(len(idx))],
        np.int32,
    )
    return {
        "feats": np.asarray(features, np.float32),
        "paths": paths,
        "input_lengths": np.full((len(idx),), temporal, np.int64),
        "target_lengths": np.asarray(lengths, np.int64),
        "future_target": future,
    }


def get(cfg):
    def prepare(labels, frame_counts):
        data = prepare_v1(
            labels, frame_counts, cfg.temporal, cfg.gap, rgb_root=cfg.rgb_data
        )
        # drop single-timestamp videos (empty paths, see module docstring)
        return filter_samples(
            data, [i for i, t in enumerate(data["times"]) if int(t) >= 2]
        )

    return tuple(
        split_batches(cfg, split, csv_file, prepare, "features_v1",
                      collate_v1)
        for split, csv_file in
        (("train", cfg.train_file), ("val", cfg.val_file))
    )
