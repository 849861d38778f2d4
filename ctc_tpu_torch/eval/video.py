"""Window decoding and alignment (port of ``decode_windows`` and
``align_windows`` from ``ctc_tpu/eval/video.py``).

The rest of that module (video-level scores, verb mAP, relation tagging,
own-video predictions) is not ported yet (ROADMAP.md Queue 1 item 10).  The
port's model holds its own weights, so these functions take the model where
the JAX functions take ``model, state``.
"""

from __future__ import annotations

import csv

import numpy as np
import torch

from ctc_tpu_torch.decode import beam_search_decode, greedy_decode
from ctc_tpu_torch.decode.viterbi import viterbi_align
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


def decode_windows(model, batches, *, blank: int = -1,
                   out_csv: str | None = None, seq_mesh=None,
                   beam_width: int = 0):
    """Decode the label-transition path of every window.

    Args:
      batches: iterable of host batch dicts (``feats [B, T, F]``,
        ``input_lengths [B]``), e.g. the val loader.
      blank: blank id for the repeat/blank collapse; ``-1`` (the blank-free
        losses) collapses repeats only.
      out_csv: optional path, one row per window: ``batch, index, length,
        path`` (space-joined class indices).
      seq_mesh: a :class:`ctc_tpu_torch.parallel.SeqMesh`: decode runs
        T-sharded, each shard taking the previous shard's last frame label
        as its boundary
        (:func:`ctc_tpu_torch.parallel.make_seq_sharded_greedy_decode`).
      beam_width: > 0 decodes with prefix beam search (best beam kept)
        instead of greedy; needs a blank symbol, and exclusive with
        ``seq_mesh``.

    The JAX function's ``head_slice`` (the verb slice of the joint loss's
    head) comes with the joint loss (ROADMAP.md Queue 1 item 8).

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
