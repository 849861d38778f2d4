"""Experiment configuration (port of ``ctc_tpu/config.py``).

The same dataclass and the same flag spellings (``--v-class``,
``--lr-decay-rate``, ...), plus ``--device`` (default ``cuda``).  Flags whose
code is not ported yet are parsed so that spellings stay identical, and
:func:`reject_unported` refuses them with the ROADMAP item that ports them.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from dataclasses import dataclass


@dataclass
class Config:
    # data paths
    rgb_data: str = "./charades/Charades_v1_rgb/"
    rgb_my_data: str = "./charades/Mydata_rgb"
    dataset: str = "charades_ctc_next_pred"
    my_dataset: str = "charades_my_pred"
    train_file: str = "./Charades_v1_train.csv"
    val_file: str = "./Charades_v1_test.csv"
    groundtruth_lookup: str = "./groundtruth.p"
    rgb_arch: str = "i3d"
    rgb_pretrained_weights: str = ""
    features_dir: str = ""

    # training geometry
    workers: int = 8
    epochs: int = 20
    start_epoch: int = 0
    batch_size: int = 10
    lr: float = 1e-3
    lr_decay_rate: int = 3
    momentum: float = 0.9
    weight_decay: float = 1e-4
    print_train_freq: int = 10
    print_test_freq: int = 10
    resume: str = ""
    evaluate: bool = False
    video_eval: bool = False
    transition_metrics: bool = False
    decode: bool = False
    decode_beam: int = 0
    decode_align: bool = False
    inputsize: int = 224
    extract_feat_dim: int = 1024
    manual_seed: int = 0
    train_size: float = 2.0
    val_size: float = 2.0
    cache_dir: str = "./cache/"
    name: str = "test"
    accum_grad: int = 1
    alpha: float = 1.0  # CE-vs-CTC mixing scale

    # class counts + temporal geometry
    num_low_rank: int = 5
    s_class: int = 16
    o_class: int = 38
    v_class: int = 33
    c_class: int = 157
    temporal: int = 1
    gap: int = 1
    num_trans: int = 1
    node_rnn_size: int = 1024
    edge_rnn_size: int = 1024

    # parallelism
    num_hosts: int = 1
    host_id: int = 0
    coordinator: str = ""
    data_parallel: int | None = None
    model_parallel: int = 1
    seq_parallel: int = 0
    seq_microbatches: int = 0
    steps_per_dispatch: int = 1

    # training-health guards, crash recovery, tracing
    max_restarts: int = 0
    skip_nonfinite: bool = False
    grad_norm_freq: int = 0
    profile_dir: str = ""

    # loss / kernel selection
    loss: str = "noblank"  # noblank | binary | blank | joint | ce | bce | mlce
    joint_object_weight: float = 1.0
    lattice_impl: str | None = None  # torch | cuda | None (by device)
    compute_dtype: str = "f32"
    dropout: float = 0.3
    finetune_i3d: bool = False
    i3d_act_dtype: str = "f32"
    i3d_chunk: int = 0

    # where the model runs: 'cuda' unless the caller asks for 'cpu'
    device: str = "cuda"

    # derived (finalize())
    cache: str = ""

    def finalize(self) -> "Config":
        self.cache = os.path.join(self.cache_dir, self.name) + os.sep
        os.makedirs(self.cache, exist_ok=True)
        return self

    @property
    def head_classes(self) -> int:
        """Model head width for the selected loss's target space."""
        return {
            "binary": self.o_class,
            "bce": self.o_class,
            "mlce": self.o_class,
            "blank": self.c_class,
            "joint": self.v_class + self.o_class,
        }.get(self.loss, self.v_class)

    @property
    def head_is_object_space(self) -> bool:
        """True when the head predicts the 38-object space (multi-hot
        losses); decides which gt-table column video eval scores against."""
        return self.loss in ("binary", "bce", "mlce")


#: (flag, predicate on the config, ROADMAP item that ports it)
UNPORTED = (
    ("--data-parallel", lambda c: c.data_parallel is not None,
     "Queue 1 item 14"),
    ("--model-parallel", lambda c: c.model_parallel > 1, "Queue 1 item 14"),
    ("--num-hosts", lambda c: c.num_hosts > 1, "Queue 1 item 14"),
    ("--compute-dtype bf16", lambda c: c.compute_dtype != "f32",
     "Queue 1 item 16"),
    ("a *_pixels dataset", lambda c: c.dataset.endswith("_pixels"),
     "Queue 1 item 12"),
    # without cached features a Charades dataset extracts them with the I3D
    ("a Charades dataset without --features-dir (feature extraction)",
     lambda c: c.dataset != "synthetic" and not c.features_dir,
     "Queue 1 item 12"),
    ("--rgb-pretrained-weights without --features-dir",
     lambda c: bool(c.rgb_pretrained_weights) and not c.features_dir,
     "Queue 1 item 12"),
    ("--finetune-i3d", lambda c: c.finetune_i3d, "Queue 1 item 12"),
    ("--i3d-act-dtype bf16", lambda c: c.i3d_act_dtype != "f32",
     "Queue 1 item 12"),
    ("--i3d-chunk", lambda c: c.i3d_chunk > 0, "Queue 1 item 12"),
)


def reject_unported(cfg: Config) -> None:
    """Raise ``NotImplementedError`` for the first flag whose code is not
    ported yet; such a flag is never silently ignored."""
    for flag, used, item in UNPORTED:
        if used(cfg):
            raise NotImplementedError(
                f"{flag} is not ported to ctc_tpu_torch yet (ROADMAP.md "
                f"{item})"
            )
    if cfg.lattice_impl not in (None, "torch", "cuda"):
        raise ValueError(
            f"--lattice-impl must be torch or cuda, got {cfg.lattice_impl!r}"
        )


def parse(argv=None) -> Config:
    """Parse CLI flags into a Config (the JAX package's flag spellings)."""
    parser = argparse.ArgumentParser(description="ctc_tpu_torch training")
    for f in dataclasses.fields(Config):
        if f.name == "cache":
            continue
        flag = "--" + f.name.replace("_", "-")
        if isinstance(f.default, bool):
            parser.add_argument(flag, action="store_true", default=f.default)
        else:
            # None-defaulted optional ints (--data-parallel) parse as ints
            typ = (type(f.default) if f.default is not None
                   else (int if "int" in str(f.type) else str))
            parser.add_argument(flag, type=typ, default=f.default)
    ns = parser.parse_args(argv)
    cfg = Config(**{f.name: getattr(ns, f.name)
                    for f in dataclasses.fields(Config)
                    if f.name != "cache"})
    return cfg.finalize()
