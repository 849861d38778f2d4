"""Checkpoint save/load (port of ``ctc_tpu/train/checkpoints.py``, with
``torch.save`` in place of orbax).

A checkpoint holds the model's ``state_dict`` (parameters and BatchNorm
running statistics), the optimizer's state (Adam's moments, the update
count and the skipped-update count, as ``ctc_tpu``'s ``opt_state`` carries
them), the batch count ``step``, the epoch and the score, under
``<directory>/ckpt/<epoch>.pt``; the newest three are kept.  Loading
copies into the state's existing tensors, so a CUDA graph captured over
them stays valid.
Beside it go the human-readable ``model_{epoch:03d}_{score:.4f}.txt`` and,
for the best score, a copy at ``<directory>/ckpt_best.pt``.
"""

from __future__ import annotations

import os
import shutil

import torch

_KEEP = 3


def _ckpt_dir(directory: str) -> str:
    return os.path.join(os.path.abspath(directory), "ckpt")


def _epochs(directory: str) -> list[int]:
    path = _ckpt_dir(directory)
    if not os.path.isdir(path):
        return []
    return sorted(int(f[:-3]) for f in os.listdir(path)
                  if f.endswith(".pt") and f[:-3].isdigit())


def save(directory: str, state, epoch: int, *, score: float = 0.0,
         is_best: bool = False) -> None:
    """Persist ``state`` (a :class:`TrainState`) for ``epoch``."""
    path = _ckpt_dir(directory)
    os.makedirs(path, exist_ok=True)
    payload = {
        "model": state.model.state_dict(),
        "optimizer": state.optimizer.state_dict(),
        "step": state.step,
        "epoch": epoch,
        "score": float(score),
    }
    target = os.path.join(path, f"{epoch}.pt")
    tmp = target + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, target)
    for old in _epochs(directory)[:-_KEEP]:
        os.remove(os.path.join(path, f"{old}.pt"))
    with open(os.path.join(directory, f"model_{epoch:03d}_{score:.4f}.txt"),
              "w") as f:
        f.write(f"epoch {epoch} score {score}\n")
    if is_best:
        shutil.copyfile(target, os.path.join(directory, "ckpt_best.pt"))


def load(directory: str, state, *, epoch: int | None = None):
    """Restore into ``state``, in place; returns ``(state, epoch,
    score)``.

    No checkpoint returns the state unchanged with epoch -1.
    """
    epochs = _epochs(directory)
    if epoch is None:
        if not epochs:
            return state, -1, 0.0
        epoch = epochs[-1]
    device = next(state.model.parameters()).device
    payload = torch.load(os.path.join(_ckpt_dir(directory), f"{epoch}.pt"),
                         map_location=device, weights_only=True)
    state.model.load_state_dict(payload["model"])
    state.optimizer.load_state_dict(payload["optimizer"])
    state.step.copy_(torch.as_tensor(payload["step"]))
    return state, int(payload["epoch"]), float(payload["score"])
