"""Synthetic dataset generators (copy of ``ctc_tpu/data/synthetic.py``; the
CI stand-in for the Charades pipeline, SURVEY.md §7.2 step 6).

Produces batches shaped like the live training path of the reference
(cached-I3D-features mode): features ``[B, T, F]``, a verb label path that
follows a simple hidden transition process so the losses are learnable, and
the reference's meta lengths.
"""

from __future__ import annotations

import numpy as np


def synthetic_feature_batches(
    *,
    num_batches: int,
    batch_size: int,
    temporal: int = 10,
    feat_dim: int = 1024,
    num_classes: int = 33,
    max_path: int | None = None,
    binary: bool = False,
    seed: int = 0,
):
    """Yield a list of batch dicts with a learnable feature->path mapping.

    Each sample draws a label path (random walk over classes); features at
    timestep t are a noisy class-conditioned embedding of the active label, so
    a linear+LSTM head can fit it.  ``future_target`` is the path's final
    label (the reference's prediction target, charades_ctc_next_pred.py:612).
    """
    rng = np.random.default_rng(seed)
    max_path = max_path or temporal
    # class embeddings come from a FIXED seed so train/val splits (different
    # sample seeds) share the same feature->class mapping
    class_emb = np.random.default_rng(12345).standard_normal(
        (num_classes, feat_dim)
    ).astype(np.float32)
    batches = []
    for _ in range(num_batches):
        feats = np.zeros((batch_size, temporal, feat_dim), np.float32)
        if binary:
            paths = np.zeros((batch_size, max_path, num_classes), np.float32)
        else:
            paths = np.full((batch_size, max_path), -1, np.int32)
        in_len = np.full((batch_size,), temporal, np.int64)
        tgt_len = np.zeros((batch_size,), np.int64)
        future = np.zeros((batch_size,), np.int32)
        for b in range(batch_size):
            cap = min(max_path, num_classes, temporal)
            # a max_path of 1 (tiny blank-loss geometries) caps the draw
            # at 1 instead of overflowing the path width
            lo = min(2, cap)
            path_len = int(rng.integers(lo, max(cap, lo) + 1))
            labels = rng.choice(num_classes, size=path_len, replace=False)
            # segment boundaries: when each label becomes active
            bounds = np.sort(
                rng.choice(np.arange(1, temporal), path_len - 1, replace=False)
            )
            seg = np.zeros((temporal,), np.int64)
            for t in range(temporal):
                seg[t] = np.searchsorted(bounds, t, side="right")
            active = labels[seg]
            feats[b] = class_emb[active] + 0.1 * rng.standard_normal(
                (temporal, feat_dim)
            ).astype(np.float32)
            if binary:
                paths[b, np.arange(path_len), labels] = 1.0
            else:
                paths[b, :path_len] = labels
            tgt_len[b] = path_len
            future[b] = labels[-1]
        batches.append(
            {
                "feats": feats,
                "paths": paths,
                "input_lengths": in_len,
                "target_lengths": tgt_len,
                "future_target": future,
            }
        )
    return batches


def pack_joint_batches(batches, o_class: int):
    """Rewrite verb-lattice batches into the joint (o, v) packed convention
    (:mod:`ctc_tpu_torch.losses.joint`): the object path is the one-hot of
    ``verb % o_class`` per position — a fixed verb->object map, so both
    heads are learnable from the same class-conditioned features (the
    synthetic stand-in for the reference's factored action->(object, verb)
    vocabulary, datasets/charades_ctc_next_pred.py:105-368)."""
    out = []
    for b in batches:
        b = dict(b)
        v_paths = np.asarray(b["paths"])  # [B, L] int, -1 padded
        bsz, max_l = v_paths.shape
        o_paths = np.zeros((bsz, max_l, o_class), np.float32)
        tgt = np.asarray(b["target_lengths"])
        for i in range(bsz):
            ln = int(tgt[i])
            o_paths[i, np.arange(ln), v_paths[i, :ln] % o_class] = 1.0
        b["paths"] = np.concatenate(
            [v_paths[:, :, None].astype(np.float32), o_paths], axis=2
        )
        b["target_lengths"] = np.stack([tgt, tgt], axis=1)
        out.append(b)
    return out


def synthetic_val_video(
    *,
    num_videos: int = 12,
    windows_per_video: int = 4,
    temporal: int = 10,
    feat_dim: int = 1024,
    v_class: int = 33,
    o_class: int = 38,
    seed: int = 0,
):
    """A val_video-style split for the synthetic dataset: per-video windows
    whose features are class-conditioned on that video's verb set, plus the
    ``{vid: [[s, o, v], ...]}`` gt_table (objects via the fixed
    ``verb % o_class`` map) — gives ``--evaluate``'s video mAP and the
    (o, v) relation eval a consumer without Charades on disk."""
    rng = np.random.default_rng(seed + 77)
    class_emb = np.random.default_rng(12345).standard_normal(
        (v_class, feat_dim)
    ).astype(np.float32)
    ids, feats, gt_table = [], [], {}
    for vi in range(num_videos):
        vid = f"SYN{vi:03d}"
        n_acts = int(rng.integers(1, 4))
        verbs = rng.choice(v_class, size=n_acts, replace=False)
        gt_table[vid] = [[0, int(v) % o_class, int(v)] for v in verbs]
        for _ in range(windows_per_video):
            active = verbs[rng.integers(0, n_acts, size=temporal)]
            feats.append(
                class_emb[active]
                + 0.1 * rng.standard_normal((temporal, feat_dim)).astype(
                    np.float32
                )
            )
            ids.append(vid)
    return {"ids": ids, "features": np.stack(feats)}, gt_table
