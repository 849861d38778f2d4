"""Experiment entry point (port of ``ctc_tpu/cli/main.py``: the training path
with ``--video-eval`` and ``--transition-metrics``, ``--evaluate`` with its
video mAP, ``--groundtruth-lookup``, ``--my-dataset`` predictions and
``--decode`` / ``--decode-beam`` / ``--decode-align``,
``--seq-parallel`` / ``--seq-microbatches``, ``--model-parallel``, the
one-card trainer features ``--steps-per-dispatch`` (one CUDA graph of K
steps on the card), ``--accum-grad``, ``--skip-nonfinite``,
``--grad-norm-freq``, ``--max-restarts`` and ``--profile-dir``, and the data
axis ``--data-parallel`` / ``--num-hosts`` / ``--host-id`` /
``--coordinator``, ``--compute-dtype bf16``, and pixels mode: the
``*_pixels`` datasets with ``--finetune-i3d``, ``--i3d-act-dtype``,
``--i3d-chunk`` and ``--rgb-pretrained-weights``, and feature extraction
for a Charades dataset without ``--features-dir``).

A ``*_pixels`` dataset trains :class:`ctc_tpu_torch.models.I3DLSTM` (the
I3D in every step, frozen unless ``--finetune-i3d``), or with ``--rgb-arch
timesformer`` :class:`ctc_tpu_torch.models.TimeSformerLSTM` (TimeSformer
in the I3D's place, on 8-frame clips); any other trains the LSTM head on
features.  ``--compute-dtype bf16`` runs the head's two
matmuls in bf16, or in pixels mode the I3D's convolutions (the head stays
f32 there).  Float32 convolutions and matmuls run in full float32 on the
card (TF32 off).

Seed, tee, build the model and the trainer, build the data loaders
(string-keyed dataset registry), optionally resume, then either evaluate
once (``--evaluate``) or run the epoch loop with CSV score logs and
per-epoch checkpoints.  Runs on ``--device`` (default ``cuda``); with no
card it raises unless ``--device cpu`` was passed.

``--data-parallel N`` (or ``--num-hosts H``) trains over a process group of
N ranks: each host starts its N / H ranks itself (one rank runs in this
process, more are spawned), rank ``h * (N / H) + l`` for local rank ``l``
of host ``h``, meeting at ``--coordinator`` across hosts.  Without
``--data-parallel`` N is H times the ranks a host's cards hold (one on the
CPU), as JAX's mesh takes every device.  ``--batch-size`` is a host's
batch.  The backend is NCCL where each local rank has a card of its own,
else gloo (ranks sharing a card, the CPU, or hosts meeting at a loopback
address, which are processes of one machine).  Only rank 0 writes the log,
the CSVs, the checkpoints and the decode files.

Run: ``python -m ctc_tpu_torch.cli.main --dataset synthetic --epochs 3 ...``
"""

from __future__ import annotations

import importlib
import os
from dataclasses import dataclass

import torch

from ctc_tpu_torch import config as config_lib
from ctc_tpu_torch.models import (
    I3DLSTM,
    LSTMHead,
    TimeSformerLSTM,
    full_f32_precision,
)
from ctc_tpu_torch.train import Trainer, resolve_device
from ctc_tpu_torch.utils import Tee, seed_everything
from ctc_tpu_torch.utils.profiling import span


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


def build_model(cfg):
    """The pixels model of ``--rgb-arch`` for a ``*_pixels`` dataset
    (``I3DLSTM`` or ``TimeSformerLSTM``), else ``LSTMHead``, with the
    compute dtypes the flags ask for."""
    dtype = torch.bfloat16 if cfg.compute_dtype == "bf16" else None
    if cfg.dataset.endswith("_pixels") and cfg.rgb_arch == "timesformer":
        return TimeSformerLSTM(
            hidden=cfg.head_classes, dropout_rate=cfg.dropout,
            freeze_backbone=not cfg.finetune_i3d, feat_chunk=cfg.i3d_chunk,
            img_size=cfg.inputsize)
    if cfg.dataset.endswith("_pixels"):
        return I3DLSTM(
            hidden=cfg.head_classes, dropout_rate=cfg.dropout,
            freeze_backbone=not cfg.finetune_i3d, i3d_dtype=dtype,
            i3d_act_dtype=(torch.bfloat16 if cfg.i3d_act_dtype == "bf16"
                           else None),
            feat_chunk=cfg.i3d_chunk,
        )
    return LSTMHead(cfg.extract_feat_dim, cfg.head_classes,
                    dropout_rate=cfg.dropout, dtype=dtype)


def decoder_line(cfg) -> str | None:
    """Which JPEG decoder the run reads frames with, if it reads any:
    the pixels loader's (native or PIL), or PIL for feature extraction."""
    from ctc_tpu_torch.data import native_loader

    if cfg.dataset.endswith("_pixels"):
        return f"JPEG decoder: {native_loader.decoder()}"
    if cfg.dataset != "synthetic" and not cfg.features_dir:
        return "JPEG decoder: pil (feature extraction)"
    return None


def check_seq_flags(cfg, rank_batch: int | None = None) -> None:
    """Refuse a ``--seq-parallel`` geometry the pipeline cannot split,
    before any work; ``rank_batch`` is the rows of a data-parallel rank."""
    if cfg.seq_parallel <= 1:
        return
    if cfg.temporal % cfg.seq_parallel:
        raise SystemExit(
            f"--temporal {cfg.temporal} must be divisible by "
            f"--seq-parallel {cfg.seq_parallel} (the lattice T axis is "
            "split into equal shards)"
        )
    m = cfg.seq_microbatches or cfg.seq_parallel
    if rank_batch is None and cfg.batch_size % m:
        raise SystemExit(
            f"--batch-size {cfg.batch_size} must be divisible by the seq "
            f"pipeline's microbatch count {m} (--seq-microbatches)"
        )
    if rank_batch is not None and rank_batch % m:
        raise SystemExit(
            f"per-data-shard batch {rank_batch} must be divisible by the "
            f"seq pipeline's microbatch count {m} (--seq-microbatches)"
        )


LOOPBACK = ("127.0.0.1", "localhost", "[::1]")


@dataclass(frozen=True)
class RankPlan:
    """The data axis of a run: ``world`` ranks over ``hosts`` hosts, this
    host's ``local_ranks`` of them, each rank's row of ``second`` model or
    seq shards, the process group's backend and where the ranks meet."""

    world: int
    hosts: int
    host_id: int
    local_ranks: int
    second: int
    backend: str
    coordinator: str | None


def plan_ranks(cfg) -> RankPlan | None:
    """The data axis that ``--data-parallel`` / ``--num-hosts`` ask for
    (None when neither does), checked before any work with the
    ``SystemExit`` messages of ``ctc_tpu``'s CLI."""
    from ctc_tpu_torch.parallel.launch import free_port
    from ctc_tpu_torch.parallel.mesh import pick_backend

    hosts = cfg.num_hosts
    if cfg.data_parallel is None and hosts <= 1:
        return None
    second = max(cfg.model_parallel, cfg.seq_parallel, 1)
    cards = (torch.cuda.device_count()
             if torch.device(cfg.device).type == "cuda" else 1)
    world = cfg.data_parallel or hosts * max(cards // second, 1)
    if world < 1 or world % hosts:
        raise SystemExit(f"--data-parallel {world} must be a positive "
                         f"multiple of --num-hosts {hosts}")
    if hosts > 1 and not cfg.coordinator:
        raise SystemExit(f"--num-hosts {hosts} needs --coordinator "
                         "host:port (where host 0 listens)")
    global_batch = cfg.batch_size * hosts
    if global_batch % world:
        raise SystemExit(
            f"--batch-size {cfg.batch_size} × {hosts} hosts = global batch "
            f"{global_batch} must be divisible by the data-parallel axis "
            f"({world} ranks)"
        )
    check_seq_flags(cfg, rank_batch=global_batch // world)
    local = world // hosts
    if hosts > 1:
        coordinator = cfg.coordinator
    else:
        coordinator = f"127.0.0.1:{free_port()}" if world > 1 else None
    # hosts that meet at a loopback address are processes of this machine,
    # and a rank's cards follow its local rank, so the hosts' ranks share
    # cards: NCCL would refuse them
    one_machine = hosts > 1 and coordinator.rsplit(":", 1)[0] in LOOPBACK
    backend = ("gloo" if one_machine
               else pick_backend(cfg.device, local, second))
    return RankPlan(world=world, hosts=hosts, host_id=cfg.host_id,
                    local_ranks=local, second=second, backend=backend,
                    coordinator=coordinator)


def run_rank(local_rank: int, cfg, plan: RankPlan):
    """One rank of a data-parallel run: join the process group, build the
    mesh, run, and leave the group, on an error too (so the other ranks
    see it rather than wait)."""
    import torch.distributed as dist

    from ctc_tpu_torch.parallel.mesh import (
        init_distributed,
        init_single_rank,
        make_mesh,
        rank_devices,
    )

    rank = plan.host_id * plan.local_ranks + local_rank
    device = rank_devices(cfg.device, local_rank, plan.second)[0]
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if plan.world == 1:
        init_single_rank(plan.backend)
    else:
        init_distributed(plan.coordinator, plan.world, rank,
                         backend=plan.backend)
    try:
        mesh = make_mesh(plan.world, model=max(cfg.model_parallel, 1),
                         seq=max(cfg.seq_parallel, 1), device=cfg.device,
                         hosts=plan.hosts)
        return run(cfg, device, mesh)
    finally:
        dist.destroy_process_group()


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
    check_decode_flags(cfg)
    device = resolve_device(cfg.device)
    plan = plan_ranks(cfg)
    if plan is None:
        check_seq_flags(cfg)
        return run(cfg, device)
    if plan.local_ranks == 1:
        return run_rank(0, cfg, plan)
    from ctc_tpu_torch.parallel.launch import spawn_ranks

    return spawn_ranks(run_rank, (cfg, plan), plan.local_ranks)[0]


def run(cfg, device, mesh=None):
    """The run of one process, on ``device``; with ``mesh`` one rank of a
    data-parallel run (its metrics or history are every rank's)."""
    writer = mesh is None or mesh.is_writer
    if writer:
        Tee(os.path.join(cfg.cache, "log.txt"))
    print(f"config: {cfg}")
    if mesh is not None:
        second = [f"{ax}={n}" for ax, n in mesh.shape.items()
                  if ax != "data" and n > 1]
        print(f"data-parallel: {mesh.data}-way mesh"
              + (f" × {' '.join(second)}" if second else "")
              + f" ({mesh.hosts} hosts, {mesh.data} ranks, backend "
                f"{mesh.backend})")
    seed_everything(cfg.manual_seed)
    full_f32_precision()
    line = decoder_line(cfg)
    if line:
        print(line)

    with span("ctc/data/dataset"):
        train_batches, val_batches = get_dataset(cfg)
    pixels = cfg.dataset.endswith("_pixels")
    with span("ctc/models/build"):
        model = build_model(cfg)
    # the trainer's generator creates the CUDA context on the card
    with span("ctc/train/init"):
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
            mesh=mesh,
            model_parallel=cfg.model_parallel,
            i3d_optimizer=(
                {"lr": cfg.lr, "momentum": cfg.momentum,
                 "weight_decay": cfg.weight_decay,
                 "finetune": cfg.finetune_i3d}
                if pixels else None
            ),
        )
        state = trainer.init_state()
    if pixels and cfg.rgb_pretrained_weights:
        model.load_backbone(torch.load(cfg.rgb_pretrained_weights,
                                       map_location="cpu"))
        name = "TimeSformer" if cfg.rgb_arch == "timesformer" else "I3D"
        print(f"loaded pretrained {name} backbone")
    start_epoch = cfg.start_epoch
    if cfg.resume:
        from ctc_tpu_torch.train import checkpoints as ckpt

        state, epoch, score = ckpt.load(cfg.resume, state)
        if mesh is not None:
            from ctc_tpu_torch.parallel import replicate

            replicate(state, mesh)
        if epoch >= 0:
            start_epoch = epoch + 1
            print(f"resumed epoch {epoch} (score {score:.4f})")
        else:
            print("no checkpoint found, starting from scratch")

    if cfg.evaluate:
        metrics = trainer.validate(state, val_batches, epoch=start_epoch)
        print(f"evaluate: {metrics}")
        if not writer:
            # decode and the video evals run no collective: rank 0's
            return metrics
        if cfg.decode:
            # decoded transition paths per val window (blank collapse only
            # for the blank loss)
            from ctc_tpu_torch.eval.video import decode_windows
            from ctc_tpu_torch.parallel import make_seq_mesh

            seq_mesh = None
            if cfg.seq_parallel > 1:
                seq_mesh = (mesh if mesh is not None and "seq" in mesh.shape
                            else make_seq_mesh(cfg.seq_parallel, device))
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
    if cfg.video_eval and writer:  # no collective: rank 0 scores
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
