"""Synthetic dataset loader (port of ``ctc_tpu/data/loaders/synthetic.py``,
single host).

Follows the CLI's head-width convention: verb-index lattices (v_class),
multi-hot object spaces (o_class).  Final-step losses (ce/bce/mlce) get the
future label as the target instead of a lattice path.
"""

from __future__ import annotations

import numpy as np

from ctc_tpu_torch.data.synthetic import synthetic_feature_batches


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
    ``cfg.batch_size``."""
    temporal = max(cfg.temporal, 2)
    common = dict(
        batch_size=cfg.batch_size,
        temporal=temporal,
        feat_dim=cfg.extract_feat_dim,
        num_classes=cfg.head_classes,
        binary=(cfg.loss in ("binary", "bce", "mlce")),
    )
    train = synthetic_feature_batches(num_batches=8, seed=cfg.manual_seed,
                                      **common)
    val = synthetic_feature_batches(num_batches=2, seed=cfg.manual_seed + 1,
                                    **common)
    if cfg.loss in ("ce", "bce", "mlce"):
        train = _final_step_batches(train, cfg.loss)
        val = _final_step_batches(val, cfg.loss)
    return train, val
