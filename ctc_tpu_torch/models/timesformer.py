"""TimeSformer with divided space-time attention (Bertasius, Wang and
Torresani, "Is Space-Time Attention All You Need for Video
Understanding?", arXiv:2102.05095) as ``nn.Module``s: the clip backbone
of ``--rgb-arch timesformer``.

* The block is the official ``timesformer/models/vit.py``'s
  ``divided_space_time`` block, and the submodules carry its names
  (``blocks.0.temporal_attn.qkv.weight``, ``blocks.0.temporal_fc.bias``,
  ``patch_embed.proj.weight``, ``cls_token``, ``pos_embed``,
  ``time_embed``, ``norm.weight``).
* Published widths by default (ViT-B/16, ``vit_base_patch16_224``): 12
  blocks, 768 wide, 12 heads of 64, an MLP of 3072 with exact GELU,
  LayerNorm eps 1e-6, qkv biases; clips of :data:`FRAMES` frames of 224²
  cut into 16² patches, 196 a frame.
* The input contract is the pixels model's channels-last ``[B, T, frames,
  h, w, 3]``: T is folded into the batch; the output is the final
  LayerNorm's class token, ``[B, T, 768]``.
* Inside the blocks the patch tokens lie in the order ``b (h w t) m``,
  time fastest, so the temporal part's ``(b h w) t m`` is a view and only
  the spatial part's ``(b t) (h w) m`` moves the tokens.  The spatial
  attention is ``torch.nn.functional.scaled_dot_product_attention``, the
  temporal one its products written out (:class:`Attention`); matmuls run
  in full float32 on the card once :func:`~ctc_tpu_torch.models.i3d.
  full_f32_precision` has turned TF32 off, as the entry points do.
* Stochastic depth and dropout are 0: the published drop path of 0.1 acts
  only when the backbone trains, and is not ported.
* :meth:`TimeSformer.reset_parameters` is the published initialisation:
  linear weights and the class and position embeddings a normal of std
  0.02 truncated at ±2, zero biases and time embedding, LayerNorm at one
  and zero, every block's ``temporal_fc`` but the first at zero, the patch
  embedding as ``nn.Conv2d`` starts.

Each forward opens ``ctc/models/timesformer`` and inside it
``ctc/models/timesformer/{embed,temporal,spatial,mlp,norm}``, one
``temporal``, ``spatial`` and ``mlp`` span a block; each of them also
times its block on the device (:func:`~ctc_tpu_torch.utils.profiling.
span`'s ``device``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ctc_tpu_torch.utils.profiling import span

#: frames a clip (the published ``DATA.NUM_FRAMES``)
FRAMES = 8
LN_EPS = 1e-6
INIT_STD = 0.02
SPAN = "ctc/models/timesformer"


def _trunc_normal_(t: torch.Tensor, generator=None) -> torch.Tensor:
    with torch.no_grad():
        return nn.init.trunc_normal_(t, 0.0, INIT_STD, -2 * INIT_STD,
                                     2 * INIT_STD, generator=generator)


class Attention(nn.Module):
    """Multi-head self-attention over ``[N, L, C]``: qkv (with bias) ->
    ``softmax(q k^T / sqrt(head_dim)) v`` by head -> proj.

    ``fused``: the attention in one kernel
    (``scaled_dot_product_attention``, the memory-efficient one in
    float32), for the spatial part's 197 tokens; else its two batched
    products and the softmax, for the temporal part's 8 frames, where the
    fused kernel's 64 x 64 tiles run 1/64 full (H100, a 100-clip step's 12
    blocks: 46 ms against 87)."""

    def __init__(self, dim: int, num_heads: int, *, fused: bool):
        super().__init__()
        self.num_heads = num_heads
        self.fused = fused
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, length, dim = x.shape
        # [3, N, heads, L, head_dim] views of one [N, L, 3C] product
        qkv = self.qkv(x).view(n, length, 3, self.num_heads,
                               dim // self.num_heads).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]
        if self.fused:
            out = F.scaled_dot_product_attention(q, k, v)
        else:
            scores = (q @ k.transpose(-2, -1)) * q.shape[-1] ** -0.5
            out = scores.softmax(-1) @ v
        return self.proj(out.transpose(1, 2).reshape(n, length, dim))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


class PatchEmbed(nn.Module):
    """The official patch embedding's parameters (a ``patch``-strided
    ``nn.Conv2d``), applied as one matrix product over the frames' patches
    (H100, 800 frames of 224²: 4.1 ms against cuDNN's 14.8)."""

    def __init__(self, dim: int, patch: int):
        super().__init__()
        self.patch = patch
        self.proj = nn.Conv2d(3, dim, patch, stride=patch)

    def forward(self, frames: torch.Tensor) -> torch.Tensor:
        """``[N, h, w, 3]`` -> ``[N, hw, dim]``, patches in row order."""
        n, h, w, c = frames.shape
        p = self.patch
        # n (h p) (w q) c -> n h w (c p q), the convolution weight's order
        patches = frames.reshape(n, h // p, p, w // p, p, c).permute(
            0, 1, 3, 5, 2, 4).reshape(n * (h // p) * (w // p), c * p * p)
        out = F.linear(patches, self.proj.weight.view(-1, c * p * p),
                       self.proj.bias)
        return out.view(n, -1, out.shape[-1])


class Block(nn.Module):
    """One divided space-time block over ``[N, 1 + hw t, C]`` tokens, the
    class token first and the patches in ``(h w t)`` order."""

    def __init__(self, dim: int, num_heads: int, mlp_hidden: int):
        super().__init__()
        self.temporal_norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.temporal_attn = Attention(dim, num_heads, fused=False)
        self.temporal_fc = nn.Linear(dim, dim)
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = Attention(dim, num_heads, fused=True)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = Mlp(dim, mlp_hidden)

    def forward(self, x: torch.Tensor, frames: int) -> torch.Tensor:
        n, length, dim = x.shape
        hw = (length - 1) // frames
        cls, xt = x[:, :1], x[:, 1:]
        with span(f"{SPAN}/temporal", device=x.device):
            # b (h w t) m -> (b h w) t m: a view
            res = self.temporal_attn(
                self.temporal_norm1(xt).view(n * hw, frames, dim))
            xt = xt + self.temporal_fc(res.view(n, hw * frames, dim))
        with span(f"{SPAN}/spatial", device=x.device):
            # the class token once a frame, then b (h w t) m -> (b t) (h w) m
            xs = torch.cat((cls[:, None].expand(n, frames, 1, dim),
                            xt.view(n, hw, frames, dim).transpose(1, 2)), 2)
            res = self.attn(self.norm1(xs.view(n * frames, hw + 1, dim)))
            res = res.view(n, frames, hw + 1, dim)
            # the class token's outputs averaged over the frames, the
            # patches back to b (h w t) m
            x = torch.cat((cls + res[:, :, 0].mean(1, keepdim=True),
                           (xt.view(n, hw, frames, dim)
                            + res[:, :, 1:].transpose(1, 2)).reshape(
                                n, hw * frames, dim)), 1)
        with span(f"{SPAN}/mlp", device=x.device):
            return x + self.mlp(self.norm2(x))


class TimeSformer(nn.Module):
    """The backbone: clips -> ``[B, T, dim]`` features (768 at the
    published widths)."""

    def __init__(self, *, img_size: int = 224, patch_size: int = 16,
                 frames: int = FRAMES, dim: int = 768, depth: int = 12,
                 num_heads: int = 12, mlp_ratio: int = 4):
        super().__init__()
        if img_size % patch_size or dim % num_heads:
            raise ValueError(
                f"img_size {img_size} must be a multiple of patch_size "
                f"{patch_size}, dim {dim} of num_heads {num_heads}")
        self.frames = frames
        self.feature_dim = dim
        tokens = (img_size // patch_size) ** 2
        self.patch_embed = PatchEmbed(dim, patch_size)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, tokens + 1, dim))
        self.time_embed = nn.Parameter(torch.zeros(1, frames, dim))
        self.blocks = nn.ModuleList(
            Block(dim, num_heads, mlp_ratio * dim) for _ in range(depth))
        self.norm = nn.LayerNorm(dim, eps=LN_EPS)
        self.reset_parameters()

    def reset_parameters(self, generator: torch.Generator | None = None):
        for m in self.modules():
            if isinstance(m, nn.Linear):
                _trunc_normal_(m.weight, generator)
                nn.init.zeros_(m.bias)
            elif isinstance(m, nn.LayerNorm):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)
        # nn.Conv2d's own initialisation, from the generator
        proj = self.patch_embed.proj
        bound = proj.weight[0].numel() ** -0.5
        with torch.no_grad():
            for t in (proj.weight, proj.bias):
                t.uniform_(-bound, bound, generator=generator)
        _trunc_normal_(self.cls_token, generator)
        _trunc_normal_(self.pos_embed, generator)
        nn.init.zeros_(self.time_embed)
        for block in self.blocks[1:]:
            nn.init.zeros_(block.temporal_fc.weight)

    def embed(self, clips: torch.Tensor) -> torch.Tensor:
        """``[N, frames, h, w, 3]`` -> ``[N, 1 + hw frames, dim]`` tokens:
        the patches with their position and time embeddings in ``(h w
        t)`` order behind the class token."""
        n, frames = clips.shape[:2]
        if frames != self.frames:
            raise ValueError(f"clips of {frames} frames; the time embedding "
                             f"holds {self.frames}")
        x = self.patch_embed(clips.reshape((n * frames,) + clips.shape[2:]))
        dim = x.shape[-1]
        # (b t) (h w) m -> b (h w) t m, plus the embeddings
        x = (x.view(n, frames, -1, dim).transpose(1, 2)
             + self.pos_embed[0, 1:, None] + self.time_embed[0])
        cls = (self.cls_token + self.pos_embed[:, :1]).expand(n, 1, dim)
        return torch.cat((cls, x.reshape(n, -1, dim)), 1)

    def forward(self, clips: torch.Tensor, *, train: bool = False):
        """``clips``: ``[B, T, frames, h, w, 3]``; returns ``[B, T, dim]``.
        ``train`` changes nothing (no dropout, no stochastic depth)."""
        b, t = clips.shape[:2]
        with span(SPAN):
            with span(f"{SPAN}/embed", device=clips.device):
                x = self.embed(clips.reshape((b * t,) + clips.shape[2:]))
            for block in self.blocks:
                x = block(x, self.frames)
            with span(f"{SPAN}/norm", device=x.device):
                return self.norm(x[:, 0]).view(b, t, -1)


def from_official(state_dict) -> dict:
    """A checkpoint of the official code (keys under ``model.``, the
    Kinetics classifier ``head.*``) in this module's names, without the
    classifier."""
    out = {}
    for k, v in state_dict.items():
        k = k.removeprefix("model.")
        if not k.startswith("head."):
            out[k] = v
    return out
