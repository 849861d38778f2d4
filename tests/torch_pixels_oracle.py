"""Shared pieces of the pixels-mode tests (``tests/test_torch_pixels_*.py``):
ctc_tpu's pixels model composed from its InceptionI3d and LSTMHead, the
weights carried both ways, seeded pixel batches, the seeded corpus of
decodable JPEG frames with its reference-layout checkpoints, and the
tolerances the files share (each file's docstring says why)."""

import csv
import os
from functools import partial

import numpy as np
import torch

import jax
import jax.numpy as jnp
import flax.linen as fnn

from ctc_tpu.models import LSTMHead as JaxLSTMHead
from ctc_tpu.models.i3d import InceptionI3d as JaxI3d
from ctc_tpu.models.i3d import convert_torch_state_dict
from ctc_tpu.train.trainer import TrainState as JaxTrainState
from ctc_tpu_torch.data.charades_corpus import write_corpus
from ctc_tpu_torch.data.synthetic import synthetic_feature_batches
from ctc_tpu_torch.models import I3DLSTM
from ctc_tpu_torch.models.i3d import InceptionI3d

from test_torch_i3d import randomize_bn

LR = 1e-2
LOSS_TOL = dict(rtol=1e-5, atol=1e-5)
PARAM_ATOL = 2e-6
HEAD_ATOL = 2e-5
FINETUNE_HEAD_ATOL = 2e-4
BACKBONE_RTOL = 0.05
BIAS_CARRIERS = ("head.feature_head.proj.bias",
                 "head.feature_head.bn.running_mean")
FULL_LOSS_RTOL = 1e-4
#: Adam inputs with an RMS within this many eps are rounding-sensitive
#: (``tests/test_torch_loaders.py``'s rule)
NEAR_EPS = 16
GEOMETRY = ["--temporal", "4", "--gap", "2", "--num-trans", "2"]


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def head_to_jax(sd, prefix="head."):
    """flax ``params`` / ``batch_stats`` of ctc_tpu's LSTMHead from the
    port's head ``state_dict`` (the inverse of ``lstm_head_from_jax``)."""
    g = {k[len(prefix):]: v.detach().numpy() for k, v in sd.items()
         if k.startswith(prefix)}
    params = {
        "feature_head": {
            "proj": {"kernel": g["feature_head.proj.weight"].T,
                     "bias": g["feature_head.proj.bias"]},
            "bn": {"scale": g["feature_head.bn.weight"],
                   "bias": g["feature_head.bn.bias"]},
        },
        "input_gates": {"kernel": g["input_gates.weight"].T,
                        "bias": g["input_gates.bias"]},
        "recurrent_kernel": g["recurrent_kernel"],
    }
    stats = {"feature_head": {"bn": {
        "mean": g["feature_head.bn.running_mean"],
        "var": g["feature_head.bn.running_var"]}}}
    return params, stats


def port_pixels_model(seed=0, **kw):
    model = I3DLSTM(hidden=33, dropout_rate=0.0, **kw)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    randomize_bn(model.i3d, seed)
    return model


class JaxPixels(fnn.Module):
    """ctc_tpu's I3DLSTM with the backbone cut at ``final_endpoint``,
    composed from ctc_tpu's InceptionI3d and LSTMHead as I3DLSTM composes
    them (its own backbone is always the full chain)."""

    final_endpoint: str = "Mixed_3c"
    freeze_backbone: bool = True

    @fnn.compact
    def __call__(self, clips, *, train=False):
        feats = JaxI3d(final_endpoint=self.final_endpoint, name="i3d")(
            clips, train=train and not self.freeze_backbone)
        if self.freeze_backbone:
            feats = jax.lax.stop_gradient(feats)
        feats = jnp.transpose(feats, (1, 0, 2)).astype(jnp.float32)
        return JaxLSTMHead(hidden=33, dropout_rate=0.0, name="head")(
            feats, train=train)


def jax_state(jtr, model):
    """ctc_tpu's train state of ``jtr`` holding the port ``model``'s
    weights (flax's init of the backbone is skipped: unjitted, it takes
    tens of seconds on the CPU)."""
    conv = convert_torch_state_dict(model.i3d.state_dict())
    head_params, head_stats = head_to_jax(model.state_dict())
    params = {"i3d": conv["params"], "head": head_params}
    stats = {"i3d": conv["batch_stats"], "head": head_stats}
    # copies: jnp.asarray of a numpy view of a tensor may share its memory,
    # which the port's step then updates in place while JAX still reads it
    copy = partial(jax.tree_util.tree_map, lambda a: jnp.array(np.array(a)))
    return JaxTrainState.create(params=copy(params),
                                batch_stats=copy(stats), tx=jtr.tx)


def adam_rms(opt):
    """Each head element's RMS of its Adam inputs so far: the square root
    of the port's bias-corrected second moment."""
    corr = 1.0 - 0.999 ** int(opt.count)
    return [(v / corr).sqrt() for v in opt.exp_avg_sq]


def pixel_batches(n, *, b=2, t=4, size=56, seed=0):
    """``n`` batches of seeded clips ``[b, t, 10, size, size, 3]`` with
    the synthetic loader's verb paths."""
    out = synthetic_feature_batches(num_batches=n, batch_size=b,
                                    temporal=t, feat_dim=1, num_classes=33,
                                    seed=seed)
    rng = np.random.default_rng(seed)
    for batch in out:
        batch["feats"] = rng.standard_normal(
            (b, t, 10, size, size, 3)).astype(np.float32)
    return out



def make_corpus(root):
    """The 4 / 2-video JPEG corpus under ``root`` (a ``pathlib.Path``) and
    the port's seeded pixels model's backbone saved in the reference's
    layout: ``(write_corpus's paths, the checkpoint with the logits head,
    the model)``."""
    out = write_corpus(str(root), seed=0, train_videos=4, val_videos=2,
                       feat_dim=16, jpeg=True)
    # checkpoints in the reference's layout: with its logits head, and
    # without (ctc_tpu's pixels CLI takes only the latter: it puts a
    # checkpoint's logits into the backbone's parameter tree, which its
    # optimizer state then does not match)
    model = port_pixels_model(seed=4)
    full = InceptionI3d()
    full.load_state_dict(model.i3d.state_dict(), strict=False)
    torch.save(full.state_dict(), root / "rgb_i3d.pt")
    torch.save(model.i3d.state_dict(), root / "rgb_i3d_backbone.pt")
    return out, str(root / "rgb_i3d.pt"), model
    return out, str(root / "rgb_i3d.pt"), model


def paths(corpus):
    out, weights, _ = corpus
    return ["--rgb-data", out["rgb_data"], "--train-file", out["train_file"],
            "--val-file", out["val_file"]]


def score_rows(run_dir):
    with open(os.path.join(run_dir, "score.csv"), newline="") as f:
        return [[float(c) for c in row] for row in csv.reader(f)]
