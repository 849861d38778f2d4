"""End-to-end pixels loader, ``--dataset charades_pixels`` (port of
``ctc_tpu/data/loaders/charades_pixels.py``).

The default dataset's windows (charades_ctc_next_pred) batched as raw
frame clips instead of I3D features, for the pixels model
(:class:`ctc_tpu_torch.models.I3DLSTM`, which runs the I3D in every step,
or ``TimeSformerLSTM``).  A batch's ``feats`` holds ``[B, T, stack, h, w,
3]`` float32 clips (602 MB at B = T = stack = 10, 224 x 224); a clip's
``stack`` follows the backbone (``--rgb-arch``): the I3D's 10 frames,
TimeSformer's 8, each ``gap + 1`` after the one before from the step's
anchor; the windows keep Charades' spacing.  The targets follow ``--loss``
as in the feature loaders.  The batches are decoded on access
(:class:`~ctc_tpu_torch.data.loaders._common.LazyBatches`), and iterating
decodes ahead on a background thread (``Prefetcher``), with the decoder of
:func:`ctc_tpu_torch.data.native_loader.decoder`.
"""

from __future__ import annotations

import numpy as np

from ctc_tpu_torch.data import charades
from ctc_tpu_torch.data.frames import STACK
from ctc_tpu_torch.data.loaders._common import LazyBatches, _index_batches
from ctc_tpu_torch.data.loading import collate_binary_ctc, collate_verb_ctc
from ctc_tpu_torch.data.native_loader import load_window_native
from ctc_tpu_torch.models import timesformer


def _pixels_collate(base_collate, gap: int, inputsize: int, stack: int):
    def collate(data, indices, _features):
        idx = list(indices)
        clips = np.stack([
            load_window_native(data["rgb_image_paths"][i], gap,
                               inputsize=inputsize, stack=stack)
            for i in idx
        ])
        batch = base_collate(data, idx, np.zeros((len(idx), clips.shape[1],
                                                  1), np.float32))
        batch["feats"] = clips.astype(np.float32, copy=False)
        return batch

    return collate


class _NoFeatures:
    """Stands where a feature array flows in the feature loaders."""

    def __getitem__(self, idx):
        return None


def get(cfg):
    base = collate_binary_ctc if cfg.loss == "binary" else collate_verb_ctc
    stack = timesformer.FRAMES if cfg.rgb_arch == "timesformer" else STACK
    collate = _pixels_collate(base, cfg.gap, cfg.inputsize, stack)
    out = []
    for split, csv_file in (("train", cfg.train_file), ("val", cfg.val_file)):
        labels = charades.parse_charades_csv(csv_file)
        frame_counts = {
            vid: charades.count_frames(cfg.rgb_data, vid) for vid in labels
        }
        data, _ = charades.cached_prepare(
            cfg.cache, split, labels, frame_counts,
            temporal=cfg.temporal, gap=cfg.gap, num_trans=cfg.num_trans,
            rgb_root=cfg.rgb_data,
        )
        if len(data["ids"]) == 0:
            out.append([])
            continue
        out.append(LazyBatches(
            data, _NoFeatures(),
            _index_batches(cfg, len(data["ids"]), split), collate,
        ))
    return out[0], out[1]
