"""Video-level evaluation, window decoding and alignment (port of
``ctc_tpu/eval/video.py``).

1. run the model over every val_video window (:func:`score_windows`);
2. aggregate per-video class scores (the mean of the windows' final-step
   logits, :func:`aggregate_video_scores`);
3. Charades mAP over future verbs, or objects for multi-hot heads
   (:func:`video_verb_map`), and for the joint (o, v) head the relation
   tagging by score composition (:func:`video_relation_eval`).

Beside it: the own-video top-k predictions, the decoded transition path
of every window and the Viterbi alignment of its target path.  The port's
model holds its own weights, so these functions take the model where the
JAX functions take ``model, state``.  The model runs on its own device;
scores come back to the host as numpy.
"""

from __future__ import annotations

import csv
from collections import defaultdict

import numpy as np
import torch

from ctc_tpu_torch.decode import beam_search_decode, greedy_decode
from ctc_tpu_torch.decode.viterbi import viterbi_align
from ctc_tpu_torch.eval.map import charades_map
from ctc_tpu_torch.eval.relation import (
    compose_ov_predictions,
    eval_visual_relation,
)
from ctc_tpu_torch.ops.emissions import (
    binary_ce_emissions,
    gather_log_softmax_emissions,
)


@torch.no_grad()
def _eval_logits(model, feats):
    """``[B, T, F]`` host features -> ``[T, B, C]`` eval-mode logits on the
    model's device."""
    device = next(model.parameters()).device
    x = torch.as_tensor(np.asarray(feats)).to(device)
    return model(x.transpose(0, 1), train=False)


def _write_csv(path, header, rows):
    with open(path, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(header)
        writer.writerows(rows)


def aggregate_video_scores(ids, window_scores) -> dict:
    """Mean per video of ``[N_windows, C]`` scores grouped by video id."""
    buckets = defaultdict(list)
    for vid, s in zip(ids, window_scores):
        buckets[vid].append(np.asarray(s))
    return {vid: np.mean(rows, axis=0) for vid, rows in buckets.items()}


def video_verb_map(video_scores: dict, gt_table: dict, num_verbs: int,
                   gt_col: int = 2):
    """Charades mAP over future verbs (or objects, for multi-hot heads).

    Args:
      video_scores: ``{vid: [num_verbs] scores}``.
      gt_table: ``{vid: [[s, o, v], ...]}`` (the val_video gt table).
      gt_col: the gt-triplet column the scores live in: 2 (verb, default)
        for verb-index heads, 1 (object) for the 38-object multi-hot heads.

    Returns ``(mAP, weighted_ap, per_class_ap)``.
    """
    vids = [v for v in gt_table if v in video_scores]
    scores = np.stack([video_scores[v] for v in vids])
    gt = np.zeros((len(vids), num_verbs), np.int64)
    for i, vid in enumerate(vids):
        for row in gt_table[vid]:
            gt[i, row[gt_col]] = 1
    return charades_map(scores, gt)


def video_relation_eval(video_o_scores: dict, video_v_scores: dict,
                        gt_table: dict):
    """(object, verb) tagging eval: compose the top pair scores per video
    and run the relation evaluation against ``gt_table`` (the scene
    dropped: ov pairs)."""
    prediction = {}
    for vid in gt_table:
        if vid not in video_o_scores:
            continue
        prediction[vid] = compose_ov_predictions(
            video_o_scores[vid], video_v_scores[vid]
        )
    gt_ov = {
        vid: [(o, v) for _, o, v in rows] for vid, rows in gt_table.items()
    }
    return eval_visual_relation(prediction, gt_ov)


def score_windows(model, feats: np.ndarray, batch_size: int = 10,
                  reduce: str = "final") -> np.ndarray:
    """Per-window class scores ``[N, C]`` for ``[N, T, F]`` host feature
    windows, in batches of ``batch_size`` moved to the model's device one
    at a time, the model in eval mode.

    ``reduce='final'`` (every product path) takes the final timestep's
    logits, the reference's prediction semantics; ``'mean'`` averages the
    logits over time.
    """
    if reduce not in ("final", "mean"):
        raise ValueError(f"reduce must be 'final' or 'mean', got {reduce!r}")
    window_scores = []
    for i0 in range(0, feats.shape[0], batch_size):
        # a copy: the cached features are a read-only memmap
        logits = _eval_logits(model, np.array(feats[i0 : i0 + batch_size]))
        out = logits[-1] if reduce == "final" else logits.mean(dim=0)
        window_scores.append(out.cpu().numpy())
    return np.concatenate(window_scores, axis=0)


def evaluate_videos(model, data, gt_table, *, batch_size: int = 10,
                    num_verbs: int = 33, gt_col: int = 2):
    """Run the model over the val_video windows and compute the mAP.

    Args:
      data: a val_video dict: ``ids`` (one video id per window) and
        ``features [N, T, F]``.
      gt_table: ``{vid: [[s, o, v], ...]}``.
    """
    window_scores = score_windows(model, np.asarray(data["features"]),
                                  batch_size)
    video_scores = aggregate_video_scores(data["ids"], window_scores)
    m_ap, _, per_class = video_verb_map(video_scores, gt_table, num_verbs,
                                        gt_col)
    return {"mAP": float(m_ap), "video_scores": video_scores,
            "per_class_ap": per_class}


def evaluate_videos_joint(model, data, gt_table, *, num_verbs: int,
                          num_objects: int, batch_size: int = 10,
                          reduce: str = "final"):
    """Video-level eval of the joint (o, v) head: verb mAP, object mAP and
    the relation-tagging metrics, the live consumer of
    :func:`video_relation_eval`.

    ``reduce`` picks the per-window reduction for both slices (see
    :func:`score_windows`).

    Returns ``{"mAP", "object_mAP", "relation_mAP", "recall_at": {50,
    100}, "prec_at": {1, 5, 10}, "video_scores", "per_class_ap"}``.
    """
    scores = score_windows(model, np.asarray(data["features"]), batch_size,
                           reduce)
    if scores.shape[1] != num_verbs + num_objects:
        raise ValueError(
            f"joint head width {scores.shape[1]} is not {num_verbs} verbs "
            f"+ {num_objects} objects"
        )
    v_scores = aggregate_video_scores(data["ids"], scores[:, :num_verbs])
    o_scores = aggregate_video_scores(data["ids"], scores[:, num_verbs:])
    v_map, _, v_per_class = video_verb_map(v_scores, gt_table, num_verbs,
                                           gt_col=2)
    o_map, _, _ = video_verb_map(o_scores, gt_table, num_objects, gt_col=1)
    rel_map, rec_at, prec_at = video_relation_eval(o_scores, v_scores,
                                                   gt_table)
    return {
        "mAP": float(v_map),
        "object_mAP": float(o_map),
        "relation_mAP": float(rel_map),
        "recall_at": rec_at,
        "prec_at": prec_at,
        "video_scores": v_scores,
        "per_class_ap": v_per_class,
    }


def decode_windows(model, batches, *, blank: int = -1,
                   out_csv: str | None = None, seq_mesh=None,
                   beam_width: int = 0, head_slice: int | None = None):
    """Decode the label-transition path of every window.

    Args:
      batches: iterable of host batch dicts (``feats [B, T, F]``,
        ``input_lengths [B]``), e.g. the val loader.
      blank: blank id for the repeat/blank collapse; ``-1`` (the blank-free
        losses) collapses repeats only.
      out_csv: optional path, one row per window: ``batch, index, length,
        path`` (space-joined class indices).
      seq_mesh: a :class:`ctc_tpu_torch.parallel.Mesh` of ``seq`` shards: decode runs
        T-sharded, each shard taking the previous shard's last frame label
        as its boundary
        (:func:`ctc_tpu_torch.parallel.make_seq_sharded_greedy_decode`).
      beam_width: > 0 decodes with prefix beam search (best beam kept)
        instead of greedy; needs a blank symbol, and exclusive with
        ``seq_mesh``.
      head_slice: decode only the first this-many classes (the verb slice
        of a joint (o, v) head).

    Returns ``{"decoded": [N, T] -1-padded, "lengths": [N]}``.
    """
    if beam_width and blank < 0:
        raise ValueError("beam decode needs a blank symbol (--loss blank)")
    if beam_width and seq_mesh is not None:
        raise ValueError("beam decode does not compose with seq_mesh")
    seq_decode = None
    if seq_mesh is not None:
        from ctc_tpu_torch.parallel import make_seq_sharded_greedy_decode

        seq_decode = make_seq_sharded_greedy_decode(seq_mesh, blank=blank)
    all_decoded, all_lengths, rows = [], [], []
    for bi, batch in enumerate(batches):
        logits = _eval_logits(model, batch["feats"])
        if head_slice:
            logits = logits[..., :head_slice]
        input_lengths = torch.as_tensor(
            np.asarray(batch["input_lengths"])).to(logits.device)
        if seq_decode is not None:
            decoded, lengths = seq_decode(logits, input_lengths)
        elif beam_width:
            prefixes, lens, _ = beam_search_decode(
                logits, input_lengths, beam_width=beam_width, blank=blank)
            decoded, lengths = prefixes[:, 0, :].to(torch.int32), lens[:, 0]
        else:
            decoded, lengths, _ = greedy_decode(logits, input_lengths,
                                                blank=blank)
        decoded, lengths = decoded.cpu().numpy(), lengths.cpu().numpy()
        all_decoded.append(decoded)
        all_lengths.append(lengths)
        for i in range(decoded.shape[0]):
            path = " ".join(str(int(c)) for c in decoded[i, : lengths[i]])
            rows.append([bi, i, int(lengths[i]), path])
    if out_csv:
        _write_csv(out_csv, ["batch", "index", "length", "path"], rows)
    return {
        "decoded": np.concatenate(all_decoded, axis=0),
        "lengths": np.concatenate(all_lengths, axis=0),
    }


def align_windows(model, batches, *, loss_kind: str = "noblank",
                  out_csv: str | None = None):
    """Viterbi time-alignment of every window's TARGET path over the
    blank-free lattice.

    The model's logits become the emissions the loss trains on (softmax
    gather for ``'noblank'``, BCE for ``'binary'``) and the best monotonic
    stay/advance alignment of frames to path positions is decoded.

    Args:
      batches: iterable of host batch dicts (``feats``, ``paths``,
        ``input_lengths``, ``target_lengths``).
      loss_kind: ``'noblank'`` (int paths) or ``'binary'`` (multi-hot
        paths); the blank lattice has another topology.
      out_csv: optional path, one row per window: ``batch, index,
        input_length, score, alignment`` (space-joined path position per
        frame).

    Returns ``{"alignment": [N, T] int32, "score": [N]}``.
    """
    if loss_kind not in ("noblank", "binary"):
        raise ValueError(
            f"alignment decodes the blank-free lattice; got {loss_kind!r}"
        )
    build = (gather_log_softmax_emissions if loss_kind == "noblank"
             else binary_ce_emissions)
    all_align, all_scores, rows = [], [], []
    for bi, batch in enumerate(batches):
        logits = _eval_logits(model, batch["feats"])  # [T, B, C]
        dev = logits.device
        paths, inlen, tgt = (torch.as_tensor(np.asarray(batch[k])).to(dev)
                             for k in ("paths", "input_lengths",
                                       "target_lengths"))
        alignment, score = viterbi_align(build(logits, paths), inlen, tgt)
        alignment = alignment.T.cpu().numpy()  # [B, T]
        score = score.cpu().numpy()
        lengths = np.asarray(batch["input_lengths"])
        all_align.append(alignment)
        all_scores.append(score)
        for i in range(alignment.shape[0]):
            ali = " ".join(str(int(p)) for p in alignment[i, : lengths[i]])
            rows.append([bi, i, int(lengths[i]), float(score[i]), ali])
    if out_csv:
        _write_csv(out_csv,
                   ["batch", "index", "input_length", "score", "alignment"],
                   rows)
    return {
        "alignment": np.concatenate(all_align, axis=0),
        "score": np.concatenate(all_scores, axis=0),
    }


def evaluate_own_video(model, data, *, out_csv: str | None = None,
                       topk: int = 5, batch_size: int = 10):
    """Own-video evaluation, the reference's my-dataset path: the
    final-timestep top-k class predictions of every dense window,
    optionally written one row per window to ``out_csv`` (video id, window
    index within the video, top-k class indices).
    """
    scores = score_windows(model, np.asarray(data["features"]), batch_size)
    top = np.argsort(-scores, axis=1)[:, :topk]
    if out_csv:
        window_of = defaultdict(int)
        rows = []
        for i, vid in enumerate(data["ids"]):
            rows.append([vid, window_of[vid]] + list(map(int, top[i])))
            window_of[vid] += 1
        _write_csv(out_csv,
                   ["id", "window"] + [f"top{k + 1}" for k in range(topk)],
                   rows)
    return {"topk": top, "scores": scores}
