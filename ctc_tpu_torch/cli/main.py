"""Experiment entry point (port of ``ctc_tpu/cli/main.py``: the training path,
``--evaluate`` and its ``--decode`` / ``--decode-beam`` / ``--decode-align``,
and ``--seq-parallel`` / ``--seq-microbatches``).

Seed, tee, build the model and the trainer, build the data loaders
(string-keyed dataset registry), optionally resume, then either validate
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
        print_test_freq=cfg.print_test_freq,
        train_size=cfg.train_size,
        val_size=cfg.val_size,
        device=device,
        seq_parallel=cfg.seq_parallel,
        seq_microbatches=cfg.seq_microbatches,
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
        print("video eval skipped: not ported to ctc_tpu_torch yet "
              "(ROADMAP.md Queue 1 item 10)")
        return metrics

    state, history = trainer.fit(train_batches, val_batches,
                                 epochs=cfg.epochs, state=state,
                                 start_epoch=start_epoch)
    if history:
        print(f"done: best val top1 "
              f"{max(h['val']['top1'] for h in history):.3f}")
    return history


if __name__ == "__main__":
    main()
