"""Experiment entry point (port of ``ctc_tpu/cli/main.py``: the training path
with ``--video-eval`` and ``--transition-metrics``, ``--evaluate`` with its
video mAP, ``--groundtruth-lookup``, ``--my-dataset`` predictions and
``--decode`` / ``--decode-beam`` / ``--decode-align``,
``--seq-parallel`` / ``--seq-microbatches``, and the one-card trainer
features ``--steps-per-dispatch`` (one CUDA graph of K steps on the card),
``--accum-grad``, ``--skip-nonfinite``, ``--grad-norm-freq``,
``--max-restarts`` and ``--profile-dir``).

Seed, tee, build the model and the trainer, build the data loaders
(string-keyed dataset registry), optionally resume, then either evaluate
once (``--evaluate``) or run the epoch loop with CSV score logs and
per-epoch checkpoints.  Runs on ``--device`` (default ``cuda``); with no
card it raises unless ``--device cpu`` was passed.

Run: ``python -m ctc_tpu_torch.cli.main --dataset synthetic --epochs 3 ...``
"""

from __future__ import annotations

import importlib
import os

from ctc_tpu_torch import config as config_lib
from ctc_tpu_torch.models import LSTMHead
from ctc_tpu_torch.train import Trainer, resolve_device
from ctc_tpu_torch.utils import Tee, seed_everything


def get_dataset(cfg):
    """``ctc_tpu_torch.data.loaders.<dataset>.get(cfg)`` ->
    ``(train_batches, val_batches)``."""
    module = importlib.import_module(
        f"ctc_tpu_torch.data.loaders.{cfg.dataset}"
    )
    return module.get(cfg)


def get_val_video(cfg):
    """``(data, gt_table)`` of the dataset's val_video split, or None when
    its loader has none."""
    module = importlib.import_module(
        f"ctc_tpu_torch.data.loaders.{cfg.dataset}"
    )
    get_vv = getattr(module, "get_val_video", None)
    return None if get_vv is None else get_vv(cfg)


def evaluate_video_split(cfg, model, data, gt_table) -> dict:
    """The video-level eval the loss's head takes: verb, object and
    relation metrics for the joint head; else the mAP in the head's class
    space (multi-hot heads predict objects: gt column 1)."""
    from ctc_tpu_torch.eval.video import (
        evaluate_videos,
        evaluate_videos_joint,
    )

    if cfg.loss == "joint":
        return evaluate_videos_joint(model, data, gt_table,
                                     num_verbs=cfg.v_class,
                                     num_objects=cfg.o_class)
    return evaluate_videos(model, data, gt_table,
                           num_verbs=cfg.head_classes,
                           gt_col=(1 if cfg.head_is_object_space else 2))


def evaluate_videos_once(cfg, model, metrics) -> None:
    """``--evaluate``'s video mAP on the val_video split, against the
    ``--groundtruth-lookup`` pickle where it exists, and for the joint head
    the object mAP and the relation-tagging line; adds to ``metrics``."""
    from ctc_tpu_torch.utils.groundtruth import load_groundtruth

    vv = get_val_video(cfg)
    if vv is None:
        return
    data, gt_table = vv
    # a precomputed lookup pickle overrides the rebuilt table
    if cfg.groundtruth_lookup and os.path.exists(cfg.groundtruth_lookup):
        gt_table = load_groundtruth(cfg.groundtruth_lookup)
        print(f"groundtruth lookup: {cfg.groundtruth_lookup} "
              f"({len(gt_table)} videos)")
    elif cfg.groundtruth_lookup != config_lib.Config.groundtruth_lookup:
        # asked for but missing: say so rather than silently scoring
        # against the rebuilt table
        print(f"WARNING: --groundtruth-lookup {cfg.groundtruth_lookup} not "
              f"found; using the rebuilt gt table")
    if not len(data["ids"]):
        return
    out = evaluate_video_split(cfg, model, data, gt_table)
    metrics["video_mAP"] = out["mAP"]
    if cfg.loss != "joint":
        print(f"video mAP: {out['mAP']:.4f}")
        return
    rec = " ".join(f"R@{n}={v:.4f}" for n, v in out["recall_at"].items())
    prec = " ".join(f"P@{n}={v:.4f}" for n, v in out["prec_at"].items())
    print(f"video mAP: {out['mAP']:.4f} "
          f"(object mAP {out['object_mAP']:.4f})")
    print(f"relation tagging: mAP {out['relation_mAP']:.4f} {rec} {prec}")
    metrics["object_mAP"] = out["object_mAP"]
    metrics["relation_mAP"] = out["relation_mAP"]
    metrics["relation_recall_at"] = out["recall_at"]
    metrics["relation_prec_at"] = out["prec_at"]


def evaluate_own_videos(cfg, model) -> None:
    """The ``--my-dataset`` loader's windows: top-k predictions into the
    run's ``myvideo_predictions.csv``."""
    from ctc_tpu_torch.eval.video import evaluate_own_video

    module = importlib.import_module(
        f"ctc_tpu_torch.data.loaders.{cfg.my_dataset}"
    )
    data, _ = module.get(cfg)
    if len(data["ids"]):
        out_csv = os.path.join(cfg.cache, "myvideo_predictions.csv")
        evaluate_own_video(model, data, out_csv=out_csv)
        print(f"own-video predictions: {len(data['ids'])} windows "
              f"-> {out_csv}")


def make_video_eval(cfg):
    """``--video-eval``'s per-epoch evaluation ``state -> {"mAP": ...}``
    over the val_video split, or None when the dataset has no such
    windows."""
    vv = get_val_video(cfg)
    if vv is None or not len(vv[0]["ids"]):
        return None
    data, gt_table = vv

    def video_eval(state):
        out = evaluate_video_split(cfg, state.model, data, gt_table)
        if cfg.loss == "joint":
            print(f"video mAP: {out['mAP']:.4f} relation mAP: "
                  f"{out['relation_mAP']:.4f}")
        else:
            print(f"video mAP: {out['mAP']:.4f}")
        return out

    return video_eval


def check_seq_flags(cfg) -> None:
    """Refuse a ``--seq-parallel`` geometry the pipeline cannot split,
    before any work."""
    if cfg.seq_parallel <= 1:
        return
    if cfg.temporal % cfg.seq_parallel:
        raise SystemExit(
            f"--temporal {cfg.temporal} must be divisible by "
            f"--seq-parallel {cfg.seq_parallel} (the lattice T axis is "
            "split into equal shards)"
        )
    m = cfg.seq_microbatches or cfg.seq_parallel
    if cfg.batch_size % m:
        raise SystemExit(
            f"--batch-size {cfg.batch_size} must be divisible by the seq "
            f"pipeline's microbatch count {m} (--seq-microbatches)"
        )


def check_decode_flags(cfg) -> None:
    """Refuse a decode flag the loss cannot serve, before any eval work.

    Gated on the flags that make decode run at all, so a training run
    carrying a stale decode flag keeps working."""
    if cfg.evaluate and cfg.decode and cfg.decode_beam:
        if cfg.loss != "blank":
            raise SystemExit(
                "--decode-beam needs a blank symbol: use --loss blank"
            )
        if cfg.seq_parallel > 1:
            raise SystemExit(
                "--decode-beam does not compose with --seq-parallel "
                "(greedy decode does)"
            )
    if (cfg.evaluate and cfg.decode_align
            and cfg.loss not in ("noblank", "binary")):
        raise SystemExit(
            "--decode-align force-aligns the blank-free lattice: "
            "use --loss noblank or binary"
        )


def main(argv=None):
    cfg = config_lib.parse(argv)
    config_lib.reject_unported(cfg)
    check_seq_flags(cfg)
    check_decode_flags(cfg)
    device = resolve_device(cfg.device)
    Tee(os.path.join(cfg.cache, "log.txt"))
    print(f"config: {cfg}")
    seed_everything(cfg.manual_seed)

    train_batches, val_batches = get_dataset(cfg)
    model = LSTMHead(cfg.extract_feat_dim, cfg.head_classes,
                     dropout_rate=cfg.dropout)
    trainer = Trainer(
        model,
        loss_kind=cfg.loss,
        lr=cfg.lr,
        weight_decay=cfg.weight_decay,
        lr_decay_epochs=cfg.lr_decay_rate,
        steps_per_epoch=max(len(train_batches), 1),
        cache_dir=cfg.cache,
        print_freq=cfg.print_train_freq,
        seed=cfg.manual_seed,
        implementation=cfg.lattice_impl,
        # the reference's quirk: --alpha 1.0 (its default) means no CE term
        ce_weight=(cfg.alpha if cfg.alpha != 1.0 else 0.0),
        accum_grad=cfg.accum_grad,
        print_test_freq=cfg.print_test_freq,
        train_size=cfg.train_size,
        val_size=cfg.val_size,
        device=device,
        skip_nonfinite=cfg.skip_nonfinite,
        grad_norm_freq=cfg.grad_norm_freq,
        seq_parallel=cfg.seq_parallel,
        seq_microbatches=cfg.seq_microbatches,
        steps_per_dispatch=cfg.steps_per_dispatch,
        transition_metrics=cfg.transition_metrics,
        joint_object_weight=cfg.joint_object_weight,
    )
    state = trainer.init_state()
    start_epoch = cfg.start_epoch
    if cfg.resume:
        from ctc_tpu_torch.train import checkpoints as ckpt

        state, epoch, score = ckpt.load(cfg.resume, state)
        if epoch >= 0:
            start_epoch = epoch + 1
            print(f"resumed epoch {epoch} (score {score:.4f})")
        else:
            print("no checkpoint found, starting from scratch")

    if cfg.evaluate:
        metrics = trainer.validate(state, val_batches, epoch=start_epoch)
        print(f"evaluate: {metrics}")
        if cfg.decode:
            # decoded transition paths per val window (blank collapse only
            # for the blank loss)
            from ctc_tpu_torch.eval.video import decode_windows
            from ctc_tpu_torch.parallel import make_seq_mesh

            seq_mesh = (make_seq_mesh(cfg.seq_parallel, device)
                        if cfg.seq_parallel > 1 else None)
            out_csv = os.path.join(cfg.cache, "decoded_predictions.csv")
            dec = decode_windows(
                model, val_batches,
                blank=(0 if cfg.loss == "blank" else -1),
                out_csv=out_csv, seq_mesh=seq_mesh,
                beam_width=cfg.decode_beam,
                # joint (o, v) head: decode the verb transition path
                head_slice=(cfg.v_class if cfg.loss == "joint" else None),
            )
            print(f"decoded transition paths: {len(dec['lengths'])} windows "
                  f"-> {out_csv}")
            metrics["decoded_csv"] = out_csv
        if cfg.decode_align:
            # forced alignment of the TARGET paths (Viterbi over the
            # trained blank-free lattice)
            from ctc_tpu_torch.eval.video import align_windows

            align_csv = os.path.join(cfg.cache, "decoded_alignment.csv")
            ali = align_windows(model, val_batches, loss_kind=cfg.loss,
                                out_csv=align_csv)
            print(f"aligned target paths: {len(ali['score'])} windows "
                  f"-> {align_csv}")
            metrics["alignment_csv"] = align_csv
        try:
            evaluate_videos_once(cfg, model, metrics)
        except Exception as e:
            print(f"video eval skipped: {e}")
        try:
            evaluate_own_videos(cfg, model)
        except Exception as e:
            print(f"own-video eval skipped: {e}")
        return metrics

    video_eval = None
    if cfg.video_eval:
        try:
            video_eval = make_video_eval(cfg)
        except Exception as e:
            print(f"per-epoch video eval disabled: {e}")
    state, history = trainer.fit(train_batches, val_batches,
                                 epochs=cfg.epochs, state=state,
                                 start_epoch=start_epoch,
                                 video_eval=video_eval,
                                 max_restarts=cfg.max_restarts,
                                 profile_dir=(cfg.profile_dir or None))
    if history:
        print(f"done: best val top1 "
              f"{max(h['val']['top1'] for h in history):.3f}")
    return history


if __name__ == "__main__":
    main()
