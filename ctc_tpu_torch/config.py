"""Experiment configuration (port of ``ctc_tpu/config.py``).

The same dataclass and the same flag spellings (``--v-class``,
``--lr-decay-rate``, ...), plus ``--device`` (default ``cuda``).  Every
flag of ``ctc_tpu`` has its code in the port.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from dataclasses import dataclass

#: ``--rgb-arch``: the pixels model's clip backbone
RGB_ARCHS = {
    "i3d": "Inception-v1 I3D, 1024-d features of 10-frame clips (default)",
    "timesformer": "TimeSformer ViT-B/16, divided space-time attention, "
                   "768-d features of 8-frame clips",
}


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
        if self.lattice_impl not in (None, "torch", "cuda"):
            raise ValueError("--lattice-impl must be torch or cuda, got "
                             f"{self.lattice_impl!r}")
        if self.rgb_arch not in RGB_ARCHS:
            raise ValueError(f"--rgb-arch must be one of {sorted(RGB_ARCHS)}, "
                             f"got {self.rgb_arch!r}")
        if self.rgb_arch == "timesformer":
            self._check_timesformer()
        self.cache = os.path.join(self.cache_dir, self.name) + os.sep
        os.makedirs(self.cache, exist_ok=True)
        # fail at parse time: the chunked I3D extraction needs a frozen
        # backbone and a chunk that divides the folded clip count
        # (I3DLSTM checks again)
        if self.i3d_chunk:
            if self.finetune_i3d:
                raise ValueError(
                    "--i3d-chunk requires a frozen backbone; drop "
                    "--finetune-i3d or --i3d-chunk"
                )
            folded = self.batch_size * self.temporal
            if folded % self.i3d_chunk:
                raise ValueError(
                    f"--i3d-chunk {self.i3d_chunk} must divide "
                    f"batch_size*temporal = {folded}"
                )
        return self

    def _check_timesformer(self) -> None:
        """Refuse, before any work, the flags that the TimeSformer backbone
        does not take."""
        refused = []
        if not self.dataset.endswith("_pixels"):
            refused.append(f"--dataset {self.dataset} (a *_pixels dataset "
                           "only: feature extraction and cached features "
                           "are the I3D's)")
        if self.compute_dtype != "f32":
            refused.append(f"--compute-dtype {self.compute_dtype}")
        if self.i3d_act_dtype != "f32":
            refused.append(f"--i3d-act-dtype {self.i3d_act_dtype}")
        if refused:
            raise ValueError(f"--rgb-arch {self.rgb_arch} runs in float32 "
                             "on a *_pixels dataset; it does not take "
                             + ", ".join(refused))

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


def parse(argv=None) -> Config:
    """Parse CLI flags into a Config (the JAX package's flag spellings)."""
    parser = argparse.ArgumentParser(description="ctc_tpu_torch training")
    for f in dataclasses.fields(Config):
        if f.name == "cache":
            continue
        flag = "--" + f.name.replace("_", "-")
        if f.name == "rgb_arch":
            parser.add_argument(
                flag, choices=sorted(RGB_ARCHS), default=f.default,
                help="the pixels model's clip backbone: " + "; ".join(
                    f"{k}: {v}" for k, v in RGB_ARCHS.items()))
        elif isinstance(f.default, bool):
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
