"""End-to-end pixels models: clip features of a video backbone -> LSTM
head logits (:class:`I3DLSTM` is the port of ``ctc_tpu/models/
i3d_lstm.py``; :class:`TimeSformerLSTM` puts TimeSformer in the I3D's
place, ``--rgb-arch timesformer``).  :class:`PixelsLSTM` holds what the
two share.

``freeze_backbone=True`` (the reference's live behaviour: its I3D optimizer
step is disabled) runs the backbone under ``torch.no_grad()`` (the I3D's
BatchNorm on the running statistics), and its parameters do not require a
gradient, so the backward never reaches the backbone and no optimizer
holds state for it: ``ctc_tpu``'s ``stop_gradient`` and
``optax.set_to_zero``.  ``feat_chunk > 0`` runs the folded clips through
the frozen backbone in sequential chunks of that many, which bounds its
activation memory to one chunk.

The head always runs in float32: the I3D's dtype (``i3d_dtype``,
``i3d_act_dtype``) stops at the features (a model cast by ``.double()``
with ``i3d_act_dtype`` float64 runs in float64 throughout).
"""

from __future__ import annotations

import torch
from torch import nn

from ctc_tpu_torch.models.i3d import InceptionI3d, without_logits
from ctc_tpu_torch.models.lstm import LSTMHead
from ctc_tpu_torch.models.timesformer import TimeSformer, from_official

#: the backbones' parameter and buffer names start with one of these
BACKBONE = ("i3d.", "timesformer.")


class PixelsLSTM(nn.Module):
    """``[B, T, frames, h, w, 3]`` clips -> ``[T, B, hidden]`` logits through
    the backbone held in the attribute named :attr:`BACKBONE_ATTR`."""

    BACKBONE_ATTR = ""

    def __init__(self, backbone: nn.Module, hidden: int,
                 dropout_rate: float, *, freeze_backbone: bool,
                 feat_chunk: int):
        super().__init__()
        if feat_chunk and not freeze_backbone:
            raise ValueError(
                "feat_chunk requires freeze_backbone=True (chunked "
                "extraction never carries BN updates or gradients)"
            )
        self.freeze_backbone = freeze_backbone
        self.feat_chunk = feat_chunk
        setattr(self, self.BACKBONE_ATTR, backbone)
        self.head = LSTMHead(backbone.feature_dim, hidden, dropout_rate)
        backbone.requires_grad_(not freeze_backbone)

    @property
    def backbone(self) -> nn.Module:
        return getattr(self, self.BACKBONE_ATTR)

    def reset_parameters(self, generator: torch.Generator | None = None):
        self.backbone.reset_parameters(generator)
        self.head.reset_parameters(generator)

    def features(self, clips: torch.Tensor, *, train: bool) -> torch.Tensor:
        """``[B, T, feature_dim]`` backbone features of ``clips``."""
        backbone = self.backbone
        if not self.freeze_backbone:
            return backbone(clips, train=train)
        with torch.no_grad():
            if not self.feat_chunk:
                return backbone(clips, train=False)
            b, t = clips.shape[:2]
            if (b * t) % self.feat_chunk:
                raise ValueError(
                    f"feat_chunk={self.feat_chunk} must divide B*T={b * t}"
                )
            folded = clips.reshape((b * t,) + clips.shape[2:])
            out = [backbone(chunk, train=False)
                   for chunk in folded.split(self.feat_chunk)]
            return torch.cat(out).reshape(b, t, -1)

    def forward(self, clips: torch.Tensor, *, train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        feats = self.features(clips, train=train)
        # [T, B, F]: the head in f32 (f64 behind an f64 backbone)
        feats = feats.transpose(0, 1).to(
            torch.promote_types(feats.dtype, torch.float32))
        return self.head(feats, train=train, generator=generator)


class I3DLSTM(PixelsLSTM):
    """The I3D in :class:`PixelsLSTM`, in the attribute ``i3d``.

    ``final_endpoint`` cuts the backbone (``Mixed_5c``: 1024-d features),
    for tests at small sizes."""

    BACKBONE_ATTR = "i3d"

    def __init__(self, hidden: int = 33, dropout_rate: float = 0.3, *,
                 freeze_backbone: bool = True,
                 i3d_dtype: torch.dtype | None = None,
                 i3d_act_dtype: torch.dtype | None = None,
                 feat_chunk: int = 0, final_endpoint: str = "Mixed_5c"):
        super().__init__(
            InceptionI3d(num_classes=None, final_endpoint=final_endpoint,
                         dtype=i3d_dtype,
                         act_dtype=i3d_act_dtype or torch.float32),
            hidden, dropout_rate, freeze_backbone=freeze_backbone,
            feat_chunk=feat_chunk)

    def load_backbone(self, state_dict) -> None:
        """Load an I3D checkpoint in the reference's key layout into the
        backbone; its logits head (for Kinetics' classes) is dropped."""
        self.i3d.load_state_dict(without_logits(state_dict))


class TimeSformerLSTM(PixelsLSTM):
    """TimeSformer (divided space-time, 768-d) in :class:`PixelsLSTM`, in
    the attribute ``timesformer``; ``backbone`` takes
    :class:`~ctc_tpu_torch.models.timesformer.TimeSformer`'s keywords
    (the published widths by default)."""

    BACKBONE_ATTR = "timesformer"

    def __init__(self, hidden: int = 33, dropout_rate: float = 0.3, *,
                 freeze_backbone: bool = True, feat_chunk: int = 0,
                 **backbone):
        super().__init__(TimeSformer(**backbone), hidden, dropout_rate,
                         freeze_backbone=freeze_backbone,
                         feat_chunk=feat_chunk)

    def load_backbone(self, state_dict) -> None:
        """Load a checkpoint of the official TimeSformer code into the
        backbone; its Kinetics classifier is dropped."""
        self.timesformer.load_state_dict(from_official(state_dict))
