"""The reference of configuration ``timesformer-lstm-charades``: TimeSformer
with divided space-time attention on each step's clip of frames, then the
LSTM head and the blank-free loss of :mod:`benchmark.reference.lstm_head`,
as functions of a dict of named tensors, and this model's side of the
contract that :data:`benchmark.spec.MODEL_CONTRACT` lists.

* TimeSformer (Bertasius, Wang & Torresani, "Is Space-Time Attention All
  You Need for Video Understanding?", arXiv:2102.05095), as the official
  ``timesformer/models/vit.py`` computes ``divided_space_time``, step for
  step and in its token layouts: the frames cut into patches by a
  ``patch_size``-strided convolution, the class token and the position
  embedding added a frame, the time embedding a patch, the tokens in the
  order ``b (h w t) m``; then ``depth`` blocks of

  1. temporal attention over each patch's frames: ``temporal_norm1`` ->
     ``(b h w) t m`` -> attention -> back to ``b (h w t) m`` ->
     ``temporal_fc``, added to the patch tokens;
  2. spatial attention over each frame's patches and its copy of the
     class token: ``(b t) (h w) m``, ``norm1`` -> attention; the class
     token's outputs averaged over the frames, the patches back to ``b (h
     w t) m``, both added;
  3. ``norm2`` -> ``mlp.fc1`` -> exact GELU -> ``mlp.fc2``, added;

  and the final ``norm``'s class token as the clip's feature.  Attention
  is written out: ``softmax(q k^T / sqrt(64)) v`` by head, heads of
  :data:`HEAD_DIM` (the published 12 of 64 at 768); LayerNorm eps 1e-6;
  no dropout and no stochastic depth.  Names follow the official code's
  under ``timesformer.``; the program's names are the same.
* A clip is ``stack`` (8) frames ``gap + 1`` apart from the step's anchor.
* Frozen, the backbone runs without a gradient in blocks of ``BLOCK``
  clips; finetuned, its leaves are moved by SGD with momentum.  The head
  is Adam's either way.
* The initial weights: every linear and convolution weight a kernel over
  its fan-in, the class token and the position and time embeddings
  normals of std 0.02 (kernels over 2500), LayerNorm at one and zero, the
  biases zero.  Every block's ``temporal_fc`` is drawn: the published
  initialisation zeroes it in blocks 2-12, which with seeded weights would
  leave the temporal attention's output out of the features.
* :func:`timesformer_flops`: the matrix products (2 per multiply-add): the
  patch embedding, each block's qkv, projections, ``temporal_fc`` and MLP,
  and the attention's two products.  Frozen: the forward; finetuned, also
  each product's weight and input gradient, but the frames' gradient.

Plain ``torch`` operations only; nothing of the program is imported.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from benchmark.reference import lstm_head

PREFIX = "timesformer."
#: the width of an attention head (the published 768 / 12)
HEAD_DIM = 64
LN_EPS = 1e-6
#: fan-in of the embeddings' normals: a std of 0.02
EMBED_FAN_IN = 2500
#: clips a block of the frozen backbone's forward
BLOCK = 20
#: the attribute of the program's model whose forward the benchmark times
TIMED = "timesformer"
NORMS = ("temporal_norm1", "norm1", "norm2")
ATTENTIONS = ("temporal_attn", "attn")


def widths(conf: dict) -> dict:
    """The backbone's sizes from a configuration's keys."""
    dim = conf["embed_dim"]
    if dim != conf["num_heads"] * HEAD_DIM:
        raise ValueError(f"{conf['num_heads']} heads of {HEAD_DIM} are not "
                         f"{dim} wide")
    return {"dim": dim, "depth": conf["depth"], "patch": conf["patch_size"],
            "mlp": conf["mlp_ratio"] * dim, "frames": conf["stack"],
            "size": conf["inputsize"]}


def timesformer_shapes(*, dim: int, depth: int, patch: int, mlp: int,
                       frames: int, size: int) -> dict:
    """``{name: shape}`` of the backbone's parameters, in the order of the
    initial weights' draw."""
    out = {"patch_embed.proj.weight": (dim, 3, patch, patch),
           "patch_embed.proj.bias": (dim,),
           "cls_token": (1, 1, dim),
           "pos_embed": (1, (size // patch) ** 2 + 1, dim),
           "time_embed": (1, frames, dim)}
    for i in range(depth):
        b = f"blocks.{i}."
        for norm in NORMS:
            out[f"{b}{norm}.weight"] = out[f"{b}{norm}.bias"] = (dim,)
        for attn in ATTENTIONS:
            out[f"{b}{attn}.qkv.weight"] = (3 * dim, dim)
            out[f"{b}{attn}.qkv.bias"] = (3 * dim,)
            out[f"{b}{attn}.proj.weight"] = (dim, dim)
            out[f"{b}{attn}.proj.bias"] = (dim,)
        out[f"{b}temporal_fc.weight"] = (dim, dim)
        out[f"{b}temporal_fc.bias"] = (dim,)
        out[f"{b}mlp.fc1.weight"] = (mlp, dim)
        out[f"{b}mlp.fc1.bias"] = (mlp,)
        out[f"{b}mlp.fc2.weight"] = (dim, mlp)
        out[f"{b}mlp.fc2.bias"] = (dim,)
    out["norm.weight"] = out["norm.bias"] = (dim,)
    return out


def shapes(conf: dict) -> dict:
    """``{reference name: shape}`` of the leaves and buffers, in the order
    of the initial weights' draw: the head's, then the backbone's."""
    out = lstm_head.shapes(conf)
    out.update({PREFIX + k: v
                for k, v in timesformer_shapes(**widths(conf)).items()})
    return out


def init(name: str, shape) -> tuple:
    """As :func:`lstm_head.init` for the head; for the backbone, each
    weight of two or more dimensions a kernel over its fan-in, the
    embeddings kernels over :data:`EMBED_FAN_IN`, LayerNorm's scale ones,
    the rest zeros."""
    if name.startswith(lstm_head.PREFIX):
        return lstm_head.init(name, shape)
    if name.endswith(("cls_token", "pos_embed", "time_embed")):
        return "kernel", EMBED_FAN_IN
    if name.endswith(".weight") and len(shape) > 1:
        return "kernel", math.prod(shape[1:])
    if name.endswith(".weight") and name.split(".")[-2] in NORMS + ("norm",):
        return "ones", None
    return "zeros", None


def optimizer(name: str, finetune: bool):
    """The head's leaves: Adam; the backbone's: SGD where ``finetune``,
    else none."""
    if not name.startswith(PREFIX):
        return lstm_head.optimizer(name, finetune)
    return "sgd" if finetune else None


def ref_name(name: str) -> str:
    """The program's names are the reference's."""
    return name


def clip_offsets(conf: dict) -> list:
    """Frame offsets from a step's anchor: ``stack`` frames ``gap + 1``
    apart."""
    step = conf["geometry"]["gap"] + 1
    return [step * i for i in range(conf["stack"])]


def _linear(p, prefix, x):
    return x @ p[f"{prefix}.weight"].T + p[f"{prefix}.bias"]


def _norm(p, prefix, x):
    return F.layer_norm(x, x.shape[-1:], p[f"{prefix}.weight"],
                        p[f"{prefix}.bias"], LN_EPS)


def _attention(p, prefix, x):
    """Multi-head self-attention over ``[N, L, C]``, written out."""
    n, length, dim = x.shape
    heads = dim // HEAD_DIM
    qkv = _linear(p, f"{prefix}.qkv", x).reshape(
        n, length, 3, heads, HEAD_DIM).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0], qkv[1], qkv[2]
    attn = torch.softmax((q @ k.transpose(-2, -1)) * HEAD_DIM ** -0.5, -1)
    out = (attn @ v).transpose(1, 2).reshape(n, length, dim)
    return _linear(p, f"{prefix}.proj", out)


def _block(p, x, frames):
    """One block over ``[B, 1 + (h w t), m]`` tokens."""
    b, length, m = x.shape
    hw = (length - 1) // frames
    # temporal: b (h w t) m -> (b h w) t m
    xt = x[:, 1:]
    res = _attention(p, "temporal_attn",
                     _norm(p, "temporal_norm1", xt).reshape(b * hw, frames,
                                                            m))
    res = _linear(p, "temporal_fc", res.reshape(b, hw * frames, m))
    xt = x[:, 1:] + res
    # spatial: the class token repeated a frame, b (h w t) m -> (b t) (h w) m
    init_cls = x[:, :1]
    cls = init_cls.repeat(1, frames, 1).reshape(b * frames, 1, m)
    xs = xt.reshape(b, hw, frames, m).permute(0, 2, 1, 3).reshape(
        b * frames, hw, m)
    res = _attention(p, "attn", _norm(p, "norm1", torch.cat((cls, xs), 1)))
    cls = res[:, 0].reshape(b, frames, m).mean(1, keepdim=True)
    res = res[:, 1:].reshape(b, frames, hw, m).permute(0, 2, 1, 3).reshape(
        b, hw * frames, m)
    x = torch.cat((init_cls, xt), 1) + torch.cat((cls, res), 1)
    # mlp
    h = F.gelu(_linear(p, "mlp.fc1", _norm(p, "norm2", x)))
    return x + _linear(p, "mlp.fc2", h)


def timesformer_features(p: dict, clips: torch.Tensor) -> torch.Tensor:
    """``[N, frames, h, w, 3]`` clips -> ``[N, dim]`` features; ``p`` maps
    the backbone's names (no prefix) to tensors."""
    n, frames = clips.shape[:2]
    w = p["patch_embed.proj.weight"]
    patch = w.shape[-1]
    # b t h w c -> (b t) c h w, patches of patch x patch
    x = F.conv2d(clips.reshape((n * frames,) + clips.shape[2:])
                 .permute(0, 3, 1, 2), w, p["patch_embed.proj.bias"],
                 stride=patch)
    x = x.flatten(2).transpose(1, 2)                # (b t) (h w) m
    m = x.shape[-1]
    cls = p["cls_token"].expand(n * frames, -1, -1)
    x = torch.cat((cls, x), 1) + p["pos_embed"]
    cls = x[:n, :1]
    x = x[:, 1:]
    hw = x.shape[1]
    # (b t) n m -> (b n) t m, the time embedding, -> b (n t) m
    x = x.reshape(n, frames, hw, m).permute(0, 2, 1, 3).reshape(
        n * hw, frames, m) + p["time_embed"]
    x = torch.cat((cls, x.reshape(n, hw * frames, m)), 1)
    for i in range(sum(k.endswith("temporal_fc.weight") for k in p)):
        x = _block(lstm_head.sub(p, f"blocks.{i}."), x, frames)
    return _norm(p, "norm", x)[:, 0]


def loss(p: dict, batch: dict, *, finetune: bool, keep: float,
         generator: torch.Generator):
    """The scalar training loss of ``batch`` (``feats [B, T, stack, h, w,
    3]`` clips, ``paths``, ``target_lengths``) under the leaves ``p``."""
    feats = batch["feats"]
    b, t = feats.shape[:2]
    clips = feats.reshape((b * t,) + feats.shape[2:])
    backbone = lstm_head.sub(p, PREFIX)
    if finetune:
        out = timesformer_features(backbone, clips)
    else:
        with torch.no_grad():
            out = torch.cat([timesformer_features(backbone, c)
                             for c in clips.split(BLOCK)])
    return lstm_head.head_loss(p, out.reshape(b, t, -1).transpose(0, 1),
                               batch, keep=keep, generator=generator)


def timesformer_parts(clips: int, *, dim: int, depth: int, patch: int,
                      mlp: int, frames: int, size: int) -> dict:
    """The backbone's forward FLOPs (2 a multiply-add) over ``clips`` clips
    by kind: ``embed`` (the patch embedding), ``linear`` (the blocks'
    weight products) and ``attention`` (the two products of each
    attention)."""
    hw = (size // patch) ** 2
    patches = frames * hw
    spatial = frames * (hw + 1)
    embed = 2 * clips * patches * dim * 3 * patch * patch
    linear = 2 * clips * depth * dim * (
        patches * 5 * dim             # temporal qkv, proj, temporal_fc
        + spatial * 4 * dim           # spatial qkv, proj
        + (patches + 1) * 2 * mlp)    # fc1, fc2
    attention = 2 * clips * depth * 2 * dim * (
        hw * frames * frames          # q k^T and attn v, each patch's frames
        + frames * (hw + 1) ** 2)     # the same, each frame's tokens
    return {"embed": embed, "linear": linear, "attention": attention}


def timesformer_flops(clips: int, *, finetune: bool = False,
                      **sizes) -> float:
    """Model FLOPs of the backbone over ``clips`` clips (``sizes`` as
    :func:`widths` gives them)."""
    parts = timesformer_parts(clips, **sizes)
    forward = sum(parts.values())
    if not finetune:
        return forward
    return 3 * forward - parts["embed"]


def step_flops(cell: dict) -> float:
    """Model FLOPs of one train step of ``cell``: the head's (with the
    projection's input gradient where the backbone trains) and the
    backbone's over the step's ``B x T`` clips."""
    conf = cell["config"]
    rows = cell["batch_size"] * conf["geometry"]["temporal"]
    return (lstm_head.head_flops(rows, conf["feature_dim"], conf["hidden"],
                                 input_grad=cell["finetune"])
            + timesformer_flops(rows, finetune=cell["finetune"],
                                **widths(conf)))
