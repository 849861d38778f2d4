"""Batch assembly, per-process index batches and background prefetch (port
of ``ctc_tpu/data/loading.py``, numpy only).

Collation into dense numpy batch dicts (the trainer moves them to the
device), each process keeping only its ``process_index``-strided shard of
one shared shuffle, and a depth-bounded background-thread prefetcher.
``ctc_tpu``'s ``device_prefetch`` (a ``jax.device_put`` pipeline the
trainer does not apply by default) is not ported here: its counterpart, a
pinned-memory copy on a side stream, is ROADMAP Queue 1 item 14.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Iterator

import numpy as np


def collate_verb_ctc(data: dict, indices, features: np.ndarray) -> dict:
    """Assemble the live verb-CTC batch (reference train.py:366-400 contract).

    Args:
      data: a ``prepare_windows`` output dict.
      indices: sample indices of this batch.
      features: ``[B, T, F]`` clip features for those samples (from the I3D
        extractor or a feature cache).

    Returns the standard batch dict (see
    :func:`ctc_tpu_torch.train.trainer.make_train_step`) using the verb
    class-index path + ``v_time`` lengths + future-verb target.
    """
    idx = list(indices)
    paths = np.stack([np.asarray(data["v_targets"][i]) for i in idx])
    temporal = paths.shape[1]
    return {
        "feats": np.asarray(features, np.float32),
        "paths": paths.astype(np.int32),
        "input_lengths": np.full((len(idx),), temporal, np.int64),
        "target_lengths": np.asarray(
            [data["v_times"][i] for i in idx], np.int64
        ),
        "future_target": np.asarray(
            [data["v_f_targets"][i] for i in idx], np.int32
        ),
    }


def collate_binary_ctc(data: dict, indices, features: np.ndarray) -> dict:
    """Multi-hot object-path batch for NoBlankBinaryCTC (o_targets/o_time)."""
    idx = list(indices)
    paths = np.stack(
        [np.asarray(data["o_targets"][i], np.float32) for i in idx]
    )
    # -1 padded rows -> zeros (masked out of the lattice by target_lengths)
    paths = np.where(paths < 0, 0.0, paths)
    temporal = paths.shape[1]
    future = np.stack(
        [np.argmax(np.asarray(data["o_f_targets"][i])) for i in idx]
    )
    return {
        "feats": np.asarray(features, np.float32),
        "paths": paths,
        "input_lengths": np.full((len(idx),), temporal, np.int64),
        "target_lengths": np.asarray(
            [data["o_times"][i] for i in idx], np.int64
        ),
        "future_target": future.astype(np.int32),
    }


def collate_joint_ctc(data: dict, indices, features: np.ndarray) -> dict:
    """Joint (o, v) two-head batch: the verb class-index path and the
    multi-hot object path PACKED into one ``paths [B, L, 1 + o_class]``
    array (column 0 = verb path, columns 1: = object multi-hot) with
    ``target_lengths [B, 2] = (v_time, o_time)`` — the batch convention of
    ``ctc_tpu.losses.joint.joint_ov_ctc_loss`` (ROADMAP Queue 1 item 8).
    Mirrors the reference loader's simultaneous o_target/v_target yield
    (its train.py:366-399)."""
    idx = list(indices)
    v_paths = np.stack(
        [np.asarray(data["v_targets"][i]) for i in idx]
    ).astype(np.float32)  # [B, L]
    o_paths = np.stack(
        [np.asarray(data["o_targets"][i], np.float32) for i in idx]
    )
    o_paths = np.where(o_paths < 0, 0.0, o_paths)  # [B, L, o_class]
    temporal = v_paths.shape[1]
    return {
        "feats": np.asarray(features, np.float32),
        "paths": np.concatenate([v_paths[:, :, None], o_paths], axis=2),
        "input_lengths": np.full((len(idx),), temporal, np.int64),
        "target_lengths": np.stack(
            [
                np.asarray([data["v_times"][i] for i in idx], np.int64),
                np.asarray([data["o_times"][i] for i in idx], np.int64),
            ],
            axis=1,
        ),
        "future_target": np.asarray(
            [data["v_f_targets"][i] for i in idx], np.int32
        ),
    }


def host_shard_indices(
    n: int, batch_size: int, *, process_index: int = 0, process_count: int = 1,
    shuffle: bool = True, seed: int = 0, drop_last: bool = True,
) -> list:
    """Deterministic per-process index batches: every process shuffles
    identically then keeps its strided shard (DistributedSampler's
    contract); ``drop_last`` drops a short final batch."""
    order = np.arange(n)
    if shuffle:
        np.random.default_rng(seed).shuffle(order)
    mine = order[process_index::process_count]
    batches = [
        mine[i : i + batch_size] for i in range(0, len(mine), batch_size)
    ]
    if drop_last and batches and len(batches[-1]) < batch_size:
        batches.pop()
    return batches


class Prefetcher:
    """Background-thread prefetch of an iterable of batches (depth-bounded)."""

    def __init__(self, make_iter: Callable[[], Iterable], depth: int = 2):
        self._make_iter = make_iter
        self._depth = depth

    def __iter__(self) -> Iterator:
        q: queue.Queue = queue.Queue(maxsize=self._depth)
        sentinel = object()
        err: list = []

        def worker():
            try:
                for item in self._make_iter():
                    q.put(item)
            except BaseException as e:  # propagate into the consumer
                err.append(e)
            finally:
                q.put(sentinel)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is sentinel:
                if err:
                    raise err[0]
                return
            yield item
