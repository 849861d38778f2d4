"""Joint (object, verb) two-head training (port of
``ctc_tpu/losses/joint.py``).

One model head of width ``v_class + o_class`` trained with both blank-free
lattices off shared features in one step: the verb NoBlankCTC on the verb
slice plus the object NoBlankBinaryCTC on the object slice.  The reference
instantiates both losses and threads object and verb targets through its
trainer, but trains only the verb head; this is what gives the (o, v)
relation-tagging eval (:func:`ctc_tpu_torch.eval.video.video_relation_eval`)
a live consumer.

Batch convention (self-describing from shapes, so every train and eval
step works unchanged):

* ``paths [B, L, 1 + o_class]``: column 0 is the verb class-index path
  (float-cast; ``-1`` padding allowed), columns 1: the multi-hot object
  path.
* ``target_lengths [B, 2]``: ``(v_time, o_time)`` per sample.
* ``logits [T, B, v_class + o_class]``: verb slice first.
"""

from __future__ import annotations

import torch

from ctc_tpu_torch.losses.noblank import (
    no_blank_binary_ctc_loss,
    no_blank_ctc_loss,
)


def split_joint_logits(logits, paths):
    """``(v_logits, o_logits)`` from a joint head, widths inferred from the
    packed paths (``o_class = paths.shape[-1] - 1``)."""
    o_class = paths.shape[-1] - 1
    v_class = logits.shape[-1] - o_class
    return logits[..., :v_class], logits[..., v_class:]


def unpack_joint_paths(paths):
    """``(v_paths [B, L] int32, o_paths [B, L, o_class])``."""
    return torch.round(paths[..., 0]).to(torch.int32), paths[..., 1:]


def joint_ov_ctc_loss(logits, paths, input_lengths, target_lengths, *,
                      implementation: str | None = None,
                      object_weight: float = 1.0):
    """Verb NoBlankCTC + ``object_weight`` x object NoBlankBinaryCTC off one
    joint head.

    Each term equals its standalone registry loss on its logits slice, so
    on the card each call runs the blank-free lattice kernels twice.

    Args:
      logits: ``[T, B, v_class + o_class]``.
      paths: ``[B, L, 1 + o_class]`` packed (see the module docstring).
      input_lengths: ``[B]``.
      target_lengths: ``[B, 2]``: ``(v_time, o_time)``.
      object_weight: scale on the object term (``--joint-object-weight``).
        The binary NLL's emissions are the mean BCE over the o_class
        classes, so its magnitude, and the shared trunk's gradient share,
        runs ~1/o_class of the verb NLL's; raise it when the object head
        undertrains.
    """
    v_logits, o_logits = split_joint_logits(logits, paths)
    v_paths, o_paths = unpack_joint_paths(paths)
    return no_blank_ctc_loss(
        v_logits, v_paths, input_lengths, target_lengths[:, 0],
        implementation=implementation,
    ) + object_weight * no_blank_binary_ctc_loss(
        o_logits, o_paths, input_lengths, target_lengths[:, 1],
        implementation=implementation,
    )
