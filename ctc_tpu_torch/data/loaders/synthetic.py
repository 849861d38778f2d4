"""Synthetic dataset loader (port of ``ctc_tpu/data/loaders/synthetic.py``).

Follows the CLI's head-width convention: verb-index lattices (v_class),
multi-hot object spaces (o_class), combined blank-CTC classes (c_class).
Final-step losses (ce/bce/mlce) get the future label as the target instead
of a lattice path.
"""

from __future__ import annotations

import numpy as np

from ctc_tpu_torch.data.synthetic import (
    pack_joint_batches,
    synthetic_feature_batches,
    synthetic_val_video,
)


def _final_step_batches(batches, loss: str):
    """Rewrite lattice batches into final-step classification batches."""
    out = []
    for b in batches:
        b = dict(b)
        future = b["future_target"]
        if loss == "ce":
            b["paths"] = future.astype(np.int32)
        else:  # bce / mlce: one-hot of the future label
            n_cls = b["paths"].shape[-1] if b["paths"].ndim == 3 else None
            one_hot = np.zeros((future.shape[0], n_cls), np.float32)
            one_hot[np.arange(future.shape[0]), future] = 1.0
            b["paths"] = one_hot
        b["target_lengths"] = np.ones_like(b["target_lengths"])
        out.append(b)
    return out


def get(cfg):
    """``(train_batches, val_batches)``: 8 and 2 seeded batches of
    ``cfg.batch_size`` rows.

    ``cfg.batch_size`` is the batch of one host: with ``--num-hosts H``
    every host draws the same seeded global batches of ``H *
    batch_size`` rows and keeps its own contiguous row block (host
    ``--host-id``), so an H-host run reproduces the one-host run at batch
    ``H * batch_size``."""
    hosts = cfg.num_hosts
    temporal = max(cfg.temporal, 2)
    # Blank CTC feasibility: a drawn label can equal 0 (the blank id), and
    # the skip rule (z[s] != blank) forces such a label through the blank
    # slot before it: one extra frame.  L <= T/2 keeps every target feasible
    # (the reference's real datasets cap L well below T the same way); with
    # L == T one sample per batch would be infeasible, with a
    # sentinel-scale NLL.  max(.., 1), not 2: at temporal 2-3 a 2-label
    # path would break L <= T/2 again.
    common = dict(
        batch_size=cfg.batch_size * hosts,
        temporal=temporal,
        max_path=(max(temporal // 2, 1) if cfg.loss == "blank" else None),
        feat_dim=cfg.extract_feat_dim,
        num_classes=cfg.head_classes,
        binary=(cfg.loss in ("binary", "bce", "mlce")),
    )
    if cfg.loss == "joint":
        # verb-lattice batches packed with the fixed verb->object map
        common.update(num_classes=cfg.v_class, binary=False)
    train = synthetic_feature_batches(num_batches=8, seed=cfg.manual_seed,
                                      **common)
    val = synthetic_feature_batches(num_batches=2, seed=cfg.manual_seed + 1,
                                    **common)
    if cfg.loss in ("ce", "bce", "mlce"):
        train = _final_step_batches(train, cfg.loss)
        val = _final_step_batches(val, cfg.loss)
    elif cfg.loss == "joint":
        train = pack_joint_batches(train, cfg.o_class)
        val = pack_joint_batches(val, cfg.o_class)
    if hosts > 1:
        lo = cfg.host_id * cfg.batch_size
        hi = lo + cfg.batch_size

        def local(batches):
            return [{k: v[lo:hi] for k, v in b.items()} for b in batches]

        train, val = local(train), local(val)
    return train, val


def get_val_video(cfg):
    """Synthetic val_video split + gt_table (the Charades loaders'
    ``get_val_video`` contract), so ``--evaluate``'s video mAP and, under
    ``--loss joint``, the (o, v) relation eval run without Charades data."""
    return synthetic_val_video(
        temporal=max(cfg.temporal, 2),
        feat_dim=cfg.extract_feat_dim,
        v_class=cfg.v_class,
        o_class=cfg.o_class,
        seed=cfg.manual_seed,
    )
