"""Visual-relation tagging evaluation: per-video AP, recall@N, precision@N
(copy of ``ctc_tpu/eval/relation.py``, which is numpy only; the port keeps
its own copy because importing ``ctc_tpu`` pulls in JAX).

The reference's definitions (its ``utils/__init__.py``): tagging
precision/recall over deduplicated predicted triplets, the VOC AP envelope,
per-video AP averaged to mAP, global recall@{50,100}, mean
precision@{1,5,10}, and the (s,o,v)/(o,v) triplet-score composition
helpers, with the score composition vectorized.
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np


def eval_tagging_scores(gt_relations, pred_relations):
    """Precision/recall curves for one video.

    Args:
      gt_relations: iterable of triplet tuples.
      pred_relations: list of ``(score, triplet)`` sorted best-first.
    """
    gt_triplets = set(tuple(r) for r in gt_relations)
    pred_triplets = []
    hit_scores = []
    seen = set()
    for s, triplet in pred_relations:
        t = tuple(triplet)
        if t not in seen:
            seen.add(t)
            pred_triplets.append(t)
            hit_scores.append(s)
    hit_scores = np.asarray(hit_scores, dtype=np.float64)
    miss = np.array([t not in gt_triplets for t in pred_triplets], dtype=bool)
    hit_scores[miss] = -np.inf
    tp = np.isfinite(hit_scores)
    cum_tp = np.cumsum(tp).astype(np.float32)
    cum_fp = np.cumsum(~tp).astype(np.float32)
    eps = np.finfo(np.float32).eps
    rec = cum_tp / max(len(gt_triplets), eps)
    prec = cum_tp / np.maximum(cum_tp + cum_fp, eps)
    return prec, rec, hit_scores


def voc_ap(rec, prec, use_07_metric: bool = False) -> float:
    """VOC average precision (interpolated PR envelope)."""
    if use_07_metric:
        ap = 0.0
        for t in np.arange(0.0, 1.1, 0.1):
            p = np.max(prec[rec >= t]) if np.sum(rec >= t) > 0 else 0.0
            ap += p / 11.0
        return float(ap)
    mrec = np.concatenate(([0.0], rec, [1.0]))
    mpre = np.concatenate(([0.0], prec, [0.0]))
    mpre = np.maximum.accumulate(mpre[::-1])[::-1]
    change = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[change + 1] - mrec[change]) * mpre[change + 1]))


def eval_visual_relation(
    prediction: dict,
    groundtruth: dict,
    rec_nreturns=(50, 100),
    prec_nreturns=(1, 5, 10),
):
    """Returns ``(mAP, recall@N dict, mean precision@N dict)``."""
    video_ap = {}
    tot_scores = defaultdict(list)
    tot_tp = defaultdict(list)
    prec_at_n = defaultdict(list)
    tot_gt_relations = 0

    for vid, gt_relations in groundtruth.items():
        if vid not in prediction:
            continue
        prec, rec, scores = eval_tagging_scores(gt_relations, prediction[vid])
        video_ap[vid] = voc_ap(rec, prec)
        tp = np.isfinite(scores)
        for nre in rec_nreturns:
            cut = min(nre, scores.size)
            tot_scores[nre].append(scores[:cut])
            tot_tp[nre].append(tp[:cut])
        for nre in prec_nreturns:
            cut = min(nre, scores.size)
            prec_at_n[nre].append(prec[cut - 1])
        tot_gt_relations += len(gt_relations)

    m_ap = float(np.mean(list(video_ap.values()))) if video_ap else float("nan")
    rec_at_n = {}
    for nre in rec_nreturns:
        scores = np.concatenate(tot_scores[nre]) if tot_scores[nre] else np.array([])
        tps = np.concatenate(tot_tp[nre]) if tot_tp[nre] else np.array([])
        if scores.size == 0:
            rec_at_n[nre] = float("nan")
            continue
        order = np.argsort(scores)[::-1]
        cum_tp = np.cumsum(tps[order]).astype(np.float32)
        rec_at_n[nre] = float(
            cum_tp[-1] / max(tot_gt_relations, np.finfo(np.float32).eps)
        )
    mprec_at_n = {
        nre: float(np.mean(prec_at_n[nre])) if prec_at_n[nre] else float("nan")
        for nre in prec_nreturns
    }
    return m_ap, rec_at_n, mprec_at_n


def _top_compose(parts, keep_each: int, keep_total: int):
    """Compose additive scores of independent heads, keep the global top."""
    tops = [np.argsort(p)[-keep_each:] for p in parts]
    score = np.zeros([len(t) for t in tops])
    for axis, (p, t) in enumerate(zip(parts, tops)):
        shape = [1] * len(parts)
        shape[axis] = len(t)
        score = score + p[t].reshape(shape)
    flat = np.argsort(score, axis=None)[-keep_total:]
    coords = np.unravel_index(flat, score.shape)
    preds = [
        (
            float(score.ravel()[flat[j]]),
            tuple(int(tops[a][coords[a][j]]) for a in range(len(parts))),
        )
        for j in range(flat.size)
    ]
    return sorted(preds, key=lambda x: x[0], reverse=True)


def compose_predictions(scores_s, scores_o, scores_v,
                        keep_each: int = 10, keep_total: int = 200):
    """(scene, object, verb) triplet composition (utils/__init__.py:115-132)."""
    return _top_compose(
        [np.asarray(scores_s), np.asarray(scores_o), np.asarray(scores_v)],
        keep_each, keep_total,
    )


def compose_ov_predictions(scores_o, scores_v,
                           keep_each: int = 10, keep_total: int = 100):
    """(object, verb) pair composition (utils/__init__.py:135-150)."""
    return _top_compose(
        [np.asarray(scores_o), np.asarray(scores_v)], keep_each, keep_total
    )
