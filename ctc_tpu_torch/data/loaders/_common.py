"""Shared split pipeline for the Charades-variant registry loaders (port of
``ctc_tpu/data/loaders/_common.py``).

Every variant loader runs the same skeleton: parse CSV -> frame counts ->
variant ``prepare`` -> I3D features (``--features-dir``'s, or extracted by
the frozen I3D and cached) -> per-host index batches -> variant collate.
Only the prepare function, the feature file's key and the collate differ
per variant.
"""

from __future__ import annotations

import os

import numpy as np

from ctc_tpu_torch.data import charades as charades_data
from ctc_tpu_torch.data.features import extract_split_features, load_features
from ctc_tpu_torch.data.loading import Prefetcher, host_shard_indices
from ctc_tpu_torch.utils.profiling import span


def prepared_split(cfg, csv_file, prepare):
    """Parse the annotation CSV and run a variant ``prepare(labels,
    frame_counts)``; returns ``(labels, data)``."""
    labels = charades_data.parse_charades_csv(csv_file)
    frame_counts = {
        vid: charades_data.count_frames(cfg.rgb_data, vid) for vid in labels
    }
    return labels, prepare(labels, frame_counts)


def split_features(cfg, data, cache_key: str, split: str) -> np.ndarray:
    """``[N, T, F]`` clip features for a prepared split.

    ``cfg.features_dir`` set: ``<features_dir>/<cache_key>_<split>.npy``,
    memory-mapped (a missing file is an error, not a silent
    re-extraction).  Otherwise the frozen I3D extracts them, cached under
    ``<cfg.cache>/<cache_key>_<split>``."""
    if cfg.features_dir:
        return load_features(
            os.path.join(cfg.features_dir, f"{cache_key}_{split}.npy")
        )
    from ctc_tpu_torch.data.loaders.charades_ctc_next_pred import _extractor

    return extract_split_features(
        data, _extractor(cfg), os.path.join(cfg.cache, f"{cache_key}_{split}"),
        gap=cfg.gap, inputsize=cfg.inputsize,
    )


def _index_batches(cfg, n: int, split: str) -> list:
    # this host's strided share (--host-id of --num-hosts): ctc_tpu's
    # jax.process_index() of jax.process_count()
    return host_shard_indices(
        n, cfg.batch_size, process_index=cfg.host_id,
        process_count=cfg.num_hosts,
        shuffle=(split == "train"), seed=cfg.manual_seed,
    )


def shard_and_collate(cfg, data, feats, split: str, collate) -> list:
    return [
        collate(data, idx, np.asarray(feats[idx]))
        for idx in _index_batches(cfg, len(data["ids"]), split)
    ]


class LazyBatches:
    """List-like of batches collated on access; iteration collates ahead
    on a background thread (:class:`Prefetcher`)."""

    def __init__(self, data, feats, index_batches, collate, *,
                 prefetch_depth: int = 2):
        self._data = data
        self._feats = feats
        self._index_batches = index_batches
        self._collate = collate
        self._depth = prefetch_depth

    def __len__(self):
        return len(self._index_batches)

    def __getitem__(self, i):
        idx = self._index_batches[i]
        with span("ctc/data/decode"):
            return self._collate(self._data, idx, self._feats[idx])

    def __iter__(self):
        return iter(Prefetcher(
            lambda: (self[i] for i in range(len(self))), depth=self._depth
        ))


def split_batches(cfg, split: str, csv_file, prepare, cache_key: str,
                  collate) -> list:
    """The full skeleton for one split; returns collated batch dicts."""
    _, data = prepared_split(cfg, csv_file, prepare)
    if len(data["ids"]) == 0:
        return []
    feats = split_features(cfg, data, cache_key, split)
    return shard_and_collate(cfg, data, feats, split, collate)


def filter_samples(data: dict, keep) -> dict:
    """Keep only the samples at indices ``keep`` across every field list."""
    keep = list(keep)
    return {k: [v[i] for i in keep] for k, v in data.items()}
