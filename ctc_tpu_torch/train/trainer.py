"""Training engine: train/eval steps and an epoch-loop Trainer (port of
``ctc_tpu/train/trainer.py``: one device, or the lattice's T axis split
into ``seq_parallel`` shards).

* The optimizer is :class:`ctc_tpu_torch.train.optim.TorchStyleAdam`:
  Adam with ``weight_decay`` as L2 added to the gradient (optax's
  ``add_decayed_weights -> scale_by_adam -> scale_by_learning_rate``),
  wrapped as ``ctc_tpu`` wraps it in ``MultiSteps`` (``accum_grad``),
  ``skip_nonfinite_updates`` and ``log_grad_norms``.
* Two counts on the device, kept apart as in ``ctc_tpu``: the train
  state's ``step`` counts batches (it moves the accumulation's mini-step);
  the optimizer's ``count`` counts updates (the schedule and Adam's bias
  correction read it; a skipped update does not move it).  The learning
  rate of update k (k from 0) is ``schedule(k)``, read on the device.
* ``steps_per_dispatch`` K > 1 runs each group of K batches of one shape
  as one unit (:mod:`ctc_tpu_torch.train.graphs`): one CUDA graph replay
  on the card; the sub-K remainder and groups of unequal shapes run single
  steps.
* Dropout draws its masks from the trainer's own ``torch.Generator``.
* Everything runs on one explicit device, ``cuda`` unless the caller asks
  for the CPU; asking for CUDA without a card raises.
"""

from __future__ import annotations

import contextlib
import csv
import itertools
import os
import time
from dataclasses import dataclass
from functools import partial

import torch

from ctc_tpu_torch import losses
from ctc_tpu_torch.losses.joint import split_joint_logits, unpack_joint_paths
from ctc_tpu_torch.train.graphs import (
    MultiStep,
    host_rows,
    signature,
    stack_metrics,
    to_device,
)
from ctc_tpu_torch.train.guards import grad_norm_line
from ctc_tpu_torch.train.metrics import (
    AverageMeter,
    topk_accuracy,
    transition_accuracy,
    transition_recall,
)
from ctc_tpu_torch.train.optim import TorchStyleAdam, torch_style_adam
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
    """Model + optimizer + the count of batches trained so far (``ctc_tpu``'s
    ``TrainState.step``), a 0-d int64 tensor on the model's device that the
    train step moves in place."""

    model: torch.nn.Module
    optimizer: TorchStyleAdam | None
    step: torch.Tensor | int = 0

    def __post_init__(self):
        if not isinstance(self.step, torch.Tensor):
            device = next(self.model.parameters()).device
            self.step = torch.tensor(self.step, dtype=torch.int64,
                                     device=device)


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
    update k (called with the optimizer's count, a 0-d tensor; None: 0).
    ``loss_fn`` overrides the registry lookup (the sequence-sharded loss of
    :func:`ctc_tpu_torch.parallel.seq_lattice.make_seq_sharded_loss`).

    The step decides nothing on the host and reads nothing back, so the
    same function runs eagerly and inside a captured CUDA graph
    (:mod:`ctc_tpu_torch.train.graphs`).  Its metrics are 0-d tensors:
    ``loss``, ``top1``, ``top5`` and the optimizer's guard metrics.
    """
    loss_fn = loss_fn or losses.LOSS_FNS[loss_kind]

    def train_step(state: TrainState, batch, generator=None):
        model, opt = state.model, state.optimizer
        opt.begin(state.step)
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
        loss.backward()
        lr = 0.0 if schedule is None else schedule(opt.count)
        guards = opt.step(state.step, lr)
        with torch.no_grad():
            state.step.add_(1)
            (top1, top5), _ = topk_accuracy(
                _head_logits(logits[-1], batch, loss_kind),
                batch["future_target"], topk=(1, 5)
            )
        return state, {"loss": loss.detach(), "top1": top1, "top5": top5,
                       **guards}

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

    The data-loader contract is any iterable of host (numpy) batch dicts
    (or of tensor dicts from :func:`ctc_tpu_torch.data.loading.device_prefetch`);
    epochs re-iterate the loader.

    ``seq_parallel`` > 1 splits the lattice's T axis into that many shards
    on the trainer's device (:func:`ctc_tpu_torch.parallel.make_seq_mesh`)
    and trains and evaluates through the sequence-sharded loss, with the
    batch split into ``seq_microbatches`` (default ``seq_parallel``).

    ``transition_metrics`` adds the eval step's DTW transition metrics;
    ``joint_object_weight`` scales the joint loss's object term.

    ``accum_grad`` k > 1 sums the gradients of k batches and steps on the
    k-th; ``skip_nonfinite`` drops a non-finite update and keeps the
    parameters and the optimizer's state; ``grad_norm_freq`` n > 0 prints
    the global gradient norm every n updates (the optimizer chain of
    :mod:`ctc_tpu_torch.train.optim`).  ``steps_per_dispatch`` K > 1 runs
    each group of K equal-shaped batches as one unit: one CUDA graph of K
    train (or eval) steps on the card, K steps in turn on the CPU.
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
        accum_grad: int = 1,
        print_test_freq: int | None = None,
        train_size: float = 1.0,
        val_size: float = 1.0,
        device="cuda",
        skip_nonfinite: bool = False,
        grad_norm_freq: int = 0,
        seq_parallel: int = 0,
        seq_microbatches: int = 0,
        steps_per_dispatch: int = 1,
        transition_metrics: bool = False,
        joint_object_weight: float = 1.0,
    ):
        self.device = resolve_device(device)
        self.model = model
        self.weight_decay = weight_decay
        # the schedule advances once per optimizer update: subsampling
        # (train_size < 1) shortens the epoch, and accumulation updates
        # once every accum_grad batches
        effective_steps = max(int(steps_per_epoch * min(train_size, 1.0)), 1)
        opt_steps_per_epoch = max(effective_steps // max(accum_grad, 1), 1)
        self.schedule = step_decay_schedule(lr, lr_decay_epochs,
                                            opt_steps_per_epoch)
        self.chain = {"accum_grad": accum_grad,
                      "skip_nonfinite": skip_nonfinite,
                      "grad_norm_freq": grad_norm_freq}
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
        self.steps_per_dispatch = max(steps_per_dispatch, 1)
        if self.steps_per_dispatch > 1:
            self.multi_step = MultiStep(self.train_step,
                                        self.steps_per_dispatch, train=True,
                                        device=self.device,
                                        generator=self.generator)
            self.multi_eval_step = MultiStep(self.eval_step,
                                             self.steps_per_dispatch,
                                             train=False, device=self.device)
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
        opt = torch_style_adam(self.model.parameters(), self.weight_decay,
                               **self.chain)
        return TrainState(model=self.model, optimizer=opt)

    @staticmethod
    def _uniform_shapes(group) -> bool:
        """True when every batch in a K-group has the same field shapes and
        dtypes; a group that does not (a loader's short last batch inside
        it) runs single steps, like the sub-K remainder."""
        return len({signature(b) for b in group}) == 1

    @staticmethod
    def _part(loader, size: float):
        try:
            n = len(loader)
        except TypeError:
            return loader
        return itertools.islice(iter(loader), int(n * size))

    def _groups(self, loader, size: float):
        """The loader's batches in groups of ``steps_per_dispatch``."""
        it = iter(self._part(loader, size))
        while group := list(itertools.islice(it, self.steps_per_dispatch)):
            yield group

    def _run_group(self, state, group, train: bool) -> list[dict]:
        """One group's steps; their metrics as host floats, read at once.

        A full group of equal shapes is one unit (one graph replay on the
        card); otherwise each batch is a single step."""
        k = self.steps_per_dispatch
        if k > 1 and len(group) == k and self._uniform_shapes(group):
            multi = self.multi_step if train else self.multi_eval_step
            return host_rows(multi(state, group))
        rows = []
        for host_batch in group:
            batch = to_device(host_batch, self.device)
            if train:
                state, m = self.train_step(state, batch, self.generator)
            else:
                m = self.eval_step(state, batch)
            rows.append(m)
        return host_rows(stack_metrics(rows))

    def _csv_writer(self, name):
        if not self.cache_dir:
            return None
        f = open(os.path.join(self.cache_dir, name), "a", newline="")
        return f, csv.writer(f)

    def train_epoch(self, state: TrainState, loader, epoch: int):
        meters = {k: AverageMeter() for k in ("loss", "top1", "top5", "time")}
        log = self._csv_writer("train_log.csv")
        end = time.time()
        i = 0
        try:
            for group in self._groups(loader, self.train_size):
                rows = self._run_group(state, group, train=True)
                for m in rows:
                    if m.get("grad_norm_due"):
                        print(grad_norm_line(int(m["grad_norm_step"]),
                                             m["grad_norm"]))
                for host_batch, m in zip(group, rows):
                    n = host_batch["feats"].shape[0]
                    for k in ("loss", "top1", "top5"):
                        meters[k].update(m[k], n)
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
                    i += 1
        finally:
            if log:
                log[0].close()
        return state, {k: m.avg for k, m in meters.items()}

    def validate(self, state: TrainState, loader, epoch: int):
        meters: dict[str, AverageMeter] = {}
        log = self._csv_writer("test_log.csv")
        i = 0
        try:
            for group in self._groups(loader, self.val_size):
                rows = self._run_group(state, group, train=False)
                for host_batch, m in zip(group, rows):
                    n = host_batch["feats"].shape[0]
                    for k, v in m.items():
                        meters.setdefault(k, AverageMeter()).update(v, n)
                    if log and i % self.print_test_freq == 0:
                        log[1].writerow([epoch, i, meters["loss"].val,
                                         meters["top1"].val,
                                         meters["top5"].val])
                    i += 1
        finally:
            if log:
                log[0].close()
        return {k: m.avg for k, m in meters.items()}

    def fit(self, train_loader, val_loader, *, epochs: int,
            state: TrainState | None = None, start_epoch: int = 0,
            video_eval=None, max_restarts: int = 0,
            profile_dir: str | None = None):
        """Epoch loop with per-epoch CSV score rows and checkpoints; the
        checkpoint with the best score is also copied.

        ``video_eval``: an optional per-epoch video-level evaluation
        ``state -> {"mAP": ..., ...}`` (a closure over
        :func:`ctc_tpu_torch.eval.video.evaluate_videos`).  Given one, each
        epoch's mAP goes into the val metrics and the score log's sixth
        column, and is the checkpoint's score; without it the score is the
        validation top-1.

        ``max_restarts`` > 0: an epoch that raises restores the last
        checkpoint (in place) and goes on from the epoch after it, at most
        that many times; it needs ``cache_dir``.  Without a checkpoint the
        state stays as it is and the loop restarts at ``start_epoch``.

        ``profile_dir``: a ``torch.profiler`` trace of the first trained
        epoch, written into that directory as a ``*.json`` file
        (:func:`ctc_tpu_torch.utils.profiling.trace`); an epoch that
        crashes leaves its trace and the retry is traced again."""
        from ctc_tpu_torch.train import checkpoints as ckpt

        if state is None:
            state = self.init_state()
        best = -float("inf")
        history = []
        restarts = 0
        traced = False
        score_log = self._csv_writer("score.csv")
        epoch = start_epoch
        try:
            while epoch < epochs:
                try:
                    if profile_dir and not traced:
                        from ctc_tpu_torch.utils.profiling import trace

                        ctx = trace(profile_dir,
                                    cuda=self.device.type == "cuda")
                    else:
                        ctx = contextlib.nullcontext()
                    with ctx:
                        state, train_metrics = self.train_epoch(
                            state, train_loader, epoch)
                    # only a completed epoch counts as traced
                    traced = traced or bool(profile_dir)
                    val_metrics = self.validate(state, val_loader, epoch)
                    if video_eval is not None:
                        val_metrics["mAP"] = float(video_eval(state)["mAP"])
                except Exception as e:
                    if restarts >= max_restarts or not self.cache_dir:
                        raise
                    restarts += 1
                    state, last_epoch, _ = ckpt.load(self.cache_dir, state)
                    print(f"epoch {epoch} failed ({type(e).__name__}: {e}); "
                          f"restored epoch {last_epoch}, restart {restarts}")
                    epoch = last_epoch + 1 if last_epoch >= 0 else start_epoch
                    continue
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
                epoch += 1
        finally:
            if score_log:
                score_log[0].close()
        return state, history
