"""Public loss API (port of ``ctc_tpu/losses/__init__.py``).

``LOSS_FNS`` is the loss-kind registry the train and eval steps read.  The
blank-CTC and joint (object, verb) losses are not ported yet: their entries
raise ``NotImplementedError`` naming the ROADMAP item that ports them.
"""

from ctc_tpu_torch.losses.classification import (
    bce_with_logits,
    cross_entropy,
    multilabel_cross_entropy,
)
from ctc_tpu_torch.losses.noblank import (
    no_blank_binary_ctc_loss,
    no_blank_ctc_loss,
)


def _final_step(core):
    """Adapt a final-timestep classification loss to the lattice-loss call
    signature (the CE-style prediction datasets: the target is one future
    label vector, not a lattice path)."""

    def fn(logits, paths, input_lengths, target_lengths,
           implementation=None):
        del input_lengths, target_lengths, implementation
        return core(logits[-1], paths)

    return fn


def _not_ported(kind: str, item: str):
    def fn(*args, **kwargs):
        raise NotImplementedError(
            f"--loss {kind} is not ported to ctc_tpu_torch yet "
            f"(ROADMAP.md {item})"
        )

    return fn


#: loss-kind registry shared by the train and eval steps
LOSS_FNS = {
    "noblank": no_blank_ctc_loss,
    "binary": no_blank_binary_ctc_loss,
    "blank": _not_ported("blank", "Queue 1 item 7"),
    "joint": _not_ported("joint", "Queue 1 item 8"),
    "ce": _final_step(cross_entropy),
    "bce": _final_step(bce_with_logits),
    "mlce": _final_step(multilabel_cross_entropy),
}

__all__ = [
    "no_blank_ctc_loss",
    "no_blank_binary_ctc_loss",
    "multilabel_cross_entropy",
    "cross_entropy",
    "bce_with_logits",
    "LOSS_FNS",
]
