"""Training engine: train/eval steps and an epoch-loop Trainer (port of
``ctc_tpu/train/trainer.py``: one device, or the lattice's T axis split
into ``seq_parallel`` shards).

* The optimizer is ``torch.optim.Adam`` with ``weight_decay`` as L2 added to
  the gradient — optax's ``add_decayed_weights -> scale_by_adam ->
  scale_by_learning_rate(schedule)`` chain.
* The learning rate of update k (k from 0) is ``schedule(k)``: optax reads
  the schedule with the update count before it increments.
* Dropout draws its masks from the trainer's own ``torch.Generator``.
* Everything runs on one explicit device, ``cuda`` unless the caller asks
  for the CPU; asking for CUDA without a card raises.
"""

from __future__ import annotations

import csv
import itertools
import os
import time
from dataclasses import dataclass
from functools import partial

import numpy as np
import torch

from ctc_tpu_torch import losses
from ctc_tpu_torch.losses.joint import split_joint_logits, unpack_joint_paths
from ctc_tpu_torch.train.metrics import (
    AverageMeter,
    topk_accuracy,
    transition_accuracy,
    transition_recall,
)
from ctc_tpu_torch.train.schedule import step_decay_schedule


def resolve_device(device) -> torch.device:
    """``torch.device(device)``; raises for CUDA when no card is present
    rather than running anywhere else."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} asked for, but torch.cuda.is_available() "
            "is False; pass --device cpu (device='cpu') to run on the CPU"
        )
    return dev


@dataclass
class TrainState:
    """Model + optimizer + the count of optimizer updates so far."""

    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0


def torch_style_adam(params, weight_decay: float = 0.0):
    """``torch.optim.Adam`` whose learning rate the train step sets from the
    schedule before each update."""
    return torch.optim.Adam(params, lr=0.0, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=weight_decay)


def to_device(batch, device):
    """Host batch dict (numpy) -> tensors on ``device``."""
    return {k: torch.as_tensor(np.asarray(v)).to(device)
            for k, v in batch.items()}


def _model_input(feats):
    """Batch-major features ``[B, T, F]`` -> the time-major ``[T, B, F]``
    the LSTM head scans."""
    return feats.transpose(0, 1)


def _head_logits(logits_last, batch, loss_kind):
    """Final-step logits in the metric and CE class space: the verb slice
    of the joint (o, v) head (``future_target`` is the future verb), the
    whole head otherwise."""
    if loss_kind == "joint":
        return split_joint_logits(logits_last, batch["paths"])[0]
    return logits_last


def _multi_hot_paths(logits, batch, loss_kind):
    """``(scores [T, B, C], multi-hot paths [B, L, C], path lengths [B])``
    for the transition metrics: an integer path becomes the one-hot of
    ``path mod C``; the joint head gives its verb slice and verb path."""
    paths, lengths = batch["paths"], batch["target_lengths"]
    if loss_kind == "joint":
        logits, _ = split_joint_logits(logits, paths)
        paths, _ = unpack_joint_paths(paths)
        lengths = lengths[:, 0]
    if paths.dim() == 2:
        classes = logits.shape[2]
        paths = torch.nn.functional.one_hot(
            torch.remainder(paths.long(), classes), classes
        ).to(torch.float32)
    return logits, paths, lengths


def make_train_step(loss_kind: str = "noblank", implementation=None,
                    ce_weight: float = 0.0, schedule=None, loss_fn=None):
    """Build the train step ``(state, batch, generator) -> (state,
    metrics)``.

    Batch dict (tensors on the model's device, batch-major): ``feats [B, T,
    F]``, ``paths`` (``[B, L]`` int or ``[B, L, C]`` float),
    ``input_lengths [B]``, ``target_lengths [B]``, ``future_target [B]``.
    ``ce_weight`` > 0 adds a cross-entropy term on the final timestep
    against the future target.  ``schedule(k)`` is the learning rate of
    update k.  ``loss_fn`` overrides the registry lookup (the
    sequence-sharded loss of
    :func:`ctc_tpu_torch.parallel.seq_lattice.make_seq_sharded_loss`).
    """
    loss_fn = loss_fn or losses.LOSS_FNS[loss_kind]

    def train_step(state: TrainState, batch, generator=None):
        model, opt = state.model, state.optimizer
        logits = model(_model_input(batch["feats"]), train=True,
                       generator=generator)  # [T, B, C]
        loss = loss_fn(logits, batch["paths"], batch["input_lengths"],
                       batch["target_lengths"],
                       implementation=implementation)
        if ce_weight:
            loss = loss + ce_weight * losses.cross_entropy(
                _head_logits(logits[-1], batch, loss_kind),
                batch["future_target"],
            )
        opt.zero_grad(set_to_none=True)
        loss.backward()
        if schedule is not None:
            for group in opt.param_groups:
                group["lr"] = schedule(state.step)
        opt.step()
        state.step += 1
        with torch.no_grad():
            (top1, top5), _ = topk_accuracy(
                _head_logits(logits[-1], batch, loss_kind),
                batch["future_target"], topk=(1, 5)
            )
        return state, {"loss": loss.detach(), "top1": top1, "top5": top5}

    return train_step


def make_eval_step(loss_kind: str = "noblank", implementation=None,
                   loss_fn=None, transition_metrics: bool = False):
    """Build the eval step ``(state, batch) -> metrics`` (running BatchNorm
    statistics, no dropout, no gradient); ``loss_fn`` as in
    :func:`make_train_step`.

    ``transition_metrics=True`` adds the DTW transition metrics on the
    label paths over the whole logit sequence, batch means of the
    per-sample :func:`transition_accuracy` and :func:`transition_recall`:
    ``trans_top1/5`` and ``recall_top1/5``."""
    loss_fn = loss_fn or losses.LOSS_FNS[loss_kind]

    @torch.no_grad()
    def eval_step(state: TrainState, batch):
        logits = state.model(_model_input(batch["feats"]), train=False)
        loss = loss_fn(logits, batch["paths"], batch["input_lengths"],
                       batch["target_lengths"],
                       implementation=implementation)
        extra = {}
        if transition_metrics:
            out, paths, lengths = _multi_hot_paths(logits, batch, loss_kind)
            out = out.transpose(0, 1)  # [B, T, C]
            (t1, t5), _ = transition_accuracy(out, paths, lengths)
            (r1, r5), _ = transition_recall(out, paths, lengths)
            extra = {"trans_top1": t1.mean(), "trans_top5": t5.mean(),
                     "recall_top1": r1.mean(), "recall_top5": r5.mean()}
        (top1, top5), _ = topk_accuracy(
            _head_logits(logits[-1], batch, loss_kind),
            batch["future_target"], topk=(1, 5)
        )
        return {"loss": loss, "top1": top1, "top5": top5, **extra}

    return eval_step


class Trainer:
    """Epoch-loop runner with meters, CSV logs and checkpointing.

    The data-loader contract is any iterable of host (numpy) batch dicts;
    epochs re-iterate the loader.

    ``seq_parallel`` > 1 splits the lattice's T axis into that many shards
    on the trainer's device (:func:`ctc_tpu_torch.parallel.make_seq_mesh`)
    and trains and evaluates through the sequence-sharded loss, with the
    batch split into ``seq_microbatches`` (default ``seq_parallel``).

    ``transition_metrics`` adds the eval step's DTW transition metrics;
    ``joint_object_weight`` scales the joint loss's object term.
    """

    def __init__(
        self,
        model: torch.nn.Module,
        *,
        loss_kind: str = "noblank",
        lr: float = 1e-3,
        weight_decay: float = 0.0,
        lr_decay_epochs: int = 30,
        steps_per_epoch: int = 1,
        cache_dir: str | None = None,
        print_freq: int = 100,
        seed: int = 0,
        implementation=None,
        ce_weight: float = 0.0,
        print_test_freq: int | None = None,
        train_size: float = 1.0,
        val_size: float = 1.0,
        device="cuda",
        seq_parallel: int = 0,
        seq_microbatches: int = 0,
        transition_metrics: bool = False,
        joint_object_weight: float = 1.0,
    ):
        self.device = resolve_device(device)
        self.model = model
        self.weight_decay = weight_decay
        # the schedule advances once per optimizer step; subsampling
        # (train_size < 1) shortens the epoch
        effective_steps = max(int(steps_per_epoch * min(train_size, 1.0)), 1)
        self.schedule = step_decay_schedule(lr, lr_decay_epochs,
                                            effective_steps)
        loss_fn = None
        if loss_kind == "joint" and joint_object_weight != 1.0:
            loss_fn = partial(losses.joint_ov_ctc_loss,
                              object_weight=joint_object_weight)
        if seq_parallel > 1:
            if loss_kind not in ("noblank", "binary", "blank"):
                raise ValueError(
                    f"seq_parallel needs a lattice loss, got {loss_kind!r}"
                )
            from ctc_tpu_torch.parallel import (
                make_seq_mesh,
                make_seq_sharded_loss,
            )

            loss_fn = make_seq_sharded_loss(
                make_seq_mesh(seq_parallel, self.device), loss_kind,
                num_microbatches=(seq_microbatches or None),
            )
        self.train_step = make_train_step(loss_kind, implementation,
                                          ce_weight, self.schedule,
                                          loss_fn=loss_fn)
        self.eval_step = make_eval_step(loss_kind, implementation,
                                        loss_fn=loss_fn,
                                        transition_metrics=transition_metrics)
        self.cache_dir = cache_dir
        self.print_freq = print_freq
        self.print_test_freq = (print_freq if print_test_freq is None
                                else print_test_freq)
        self.train_size = train_size
        self.val_size = val_size
        self.seed = seed
        # dropout masks; on the model's device so bernoulli_ can use it
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        if cache_dir:
            os.makedirs(cache_dir, exist_ok=True)

    def init_state(self, state_dict=None) -> TrainState:
        """Initialize the model from the trainer's seed (flax's init rule)
        or from ``state_dict``, move it to the device, and build the
        optimizer."""
        if state_dict is None:
            # drawn on the CPU, so a seed gives the same weights everywhere
            self.model.to("cpu").reset_parameters(
                torch.Generator().manual_seed(self.seed)
            )
        else:
            self.model.load_state_dict(state_dict)
        self.model.to(self.device)
        opt = torch_style_adam(self.model.parameters(), self.weight_decay)
        return TrainState(model=self.model, optimizer=opt)

    @staticmethod
    def _part(loader, size: float):
        try:
            n = len(loader)
        except TypeError:
            return loader
        return itertools.islice(iter(loader), int(n * size))

    def _csv_writer(self, name):
        if not self.cache_dir:
            return None
        f = open(os.path.join(self.cache_dir, name), "a", newline="")
        return f, csv.writer(f)

    def train_epoch(self, state: TrainState, loader, epoch: int):
        meters = {k: AverageMeter() for k in ("loss", "top1", "top5", "time")}
        log = self._csv_writer("train_log.csv")
        end = time.time()
        try:
            for i, host_batch in enumerate(self._part(loader, self.train_size)):
                batch = to_device(host_batch, self.device)
                state, metrics = self.train_step(state, batch, self.generator)
                n = batch["feats"].shape[0]
                for k in ("loss", "top1", "top5"):
                    meters[k].update(float(metrics[k]), n)
                meters["time"].update(time.time() - end)
                end = time.time()
                if i % self.print_freq == 0:
                    print(
                        f"Epoch: [{epoch}][{i}]\t"
                        f"Loss {meters['loss'].val:.3f} ({meters['loss'].avg:.3f})\t"
                        f"Prec@1 {meters['top1'].val:.3f} ({meters['top1'].avg:.3f})\t"
                        f"Prec@5 {meters['top5'].val:.3f} ({meters['top5'].avg:.3f})"
                    )
                    if log:
                        log[1].writerow([epoch, i, meters["loss"].val,
                                         meters["top1"].val,
                                         meters["top5"].val])
        finally:
            if log:
                log[0].close()
        return state, {k: m.avg for k, m in meters.items()}

    def validate(self, state: TrainState, loader, epoch: int):
        meters: dict[str, AverageMeter] = {}
        log = self._csv_writer("test_log.csv")
        try:
            for i, host_batch in enumerate(self._part(loader, self.val_size)):
                batch = to_device(host_batch, self.device)
                metrics = self.eval_step(state, batch)
                n = batch["feats"].shape[0]
                for k, v in metrics.items():
                    meters.setdefault(k, AverageMeter()).update(float(v), n)
                if log and i % self.print_test_freq == 0:
                    log[1].writerow([epoch, i, meters["loss"].val,
                                     meters["top1"].val, meters["top5"].val])
        finally:
            if log:
                log[0].close()
        return {k: m.avg for k, m in meters.items()}

    def fit(self, train_loader, val_loader, *, epochs: int,
            state: TrainState | None = None, start_epoch: int = 0,
            video_eval=None):
        """Epoch loop with per-epoch CSV score rows and checkpoints; the
        checkpoint with the best score is also copied.

        ``video_eval``: an optional per-epoch video-level evaluation
        ``state -> {"mAP": ..., ...}`` (a closure over
        :func:`ctc_tpu_torch.eval.video.evaluate_videos`).  Given one, each
        epoch's mAP goes into the val metrics and the score log's sixth
        column, and is the checkpoint's score; without it the score is the
        validation top-1."""
        from ctc_tpu_torch.train import checkpoints as ckpt

        if state is None:
            state = self.init_state()
        best = -float("inf")
        history = []
        score_log = self._csv_writer("score.csv")
        try:
            for epoch in range(start_epoch, epochs):
                state, train_metrics = self.train_epoch(state, train_loader,
                                                        epoch)
                val_metrics = self.validate(state, val_loader, epoch)
                if video_eval is not None:
                    val_metrics["mAP"] = float(video_eval(state)["mAP"])
                history.append({"train": train_metrics, "val": val_metrics})
                if score_log:
                    row = [epoch, train_metrics["loss"], val_metrics["loss"],
                           val_metrics["top1"], val_metrics["top5"]]
                    if "mAP" in val_metrics:
                        row.append(val_metrics["mAP"])
                    score_log[1].writerow(row)
                    score_log[0].flush()
                if self.cache_dir:
                    score = val_metrics.get("mAP", val_metrics["top1"])
                    is_best = score > best
                    best = max(best, score)
                    ckpt.save(self.cache_dir, state, epoch, score=score,
                              is_best=is_best)
        finally:
            if score_log:
                score_log[0].close()
        return state, history
