"""End-to-end pixels model: I3D clip features -> LSTM head logits (port of
``ctc_tpu/models/i3d_lstm.py``).

``freeze_backbone=True`` (the reference's live behaviour: its I3D optimizer
step is disabled) runs the backbone under ``torch.no_grad()`` with its
BatchNorm on the running statistics, and its parameters do not require a
gradient, so the backward never reaches the convolutions and no optimizer
holds state for them: ``ctc_tpu``'s ``stop_gradient`` and
``optax.set_to_zero``.  ``feat_chunk > 0`` runs the folded clips through
the frozen backbone in sequential chunks of that many, which bounds the
convolutions' activation memory to one chunk.

The head always runs in float32: the backbone's dtype (``i3d_dtype``,
``i3d_act_dtype``) stops at the features (a model cast by ``.double()``
with ``i3d_act_dtype`` float64 runs in float64 throughout).
"""

from __future__ import annotations

import torch
from torch import nn

from ctc_tpu_torch.models.i3d import InceptionI3d, without_logits
from ctc_tpu_torch.models.lstm import LSTMHead

#: the backbone's parameter and buffer names start with this
BACKBONE = "i3d."


class I3DLSTM(nn.Module):
    """``[B, T, stack, h, w, 3]`` clips -> ``[T, B, hidden]`` logits.

    ``final_endpoint`` cuts the backbone (``Mixed_5c``: 1024-d features),
    for tests at small sizes."""

    def __init__(self, hidden: int = 33, dropout_rate: float = 0.3, *,
                 freeze_backbone: bool = True,
                 i3d_dtype: torch.dtype | None = None,
                 i3d_act_dtype: torch.dtype | None = None,
                 feat_chunk: int = 0, final_endpoint: str = "Mixed_5c"):
        super().__init__()
        if feat_chunk and not freeze_backbone:
            raise ValueError(
                "feat_chunk requires freeze_backbone=True (chunked "
                "extraction never carries BN updates or gradients)"
            )
        self.freeze_backbone = freeze_backbone
        self.feat_chunk = feat_chunk
        self.i3d = InceptionI3d(num_classes=None,
                                final_endpoint=final_endpoint,
                                dtype=i3d_dtype,
                                act_dtype=i3d_act_dtype or torch.float32)
        self.head = LSTMHead(self.i3d.feature_dim, hidden, dropout_rate)
        self.i3d.requires_grad_(not freeze_backbone)

    def reset_parameters(self, generator: torch.Generator | None = None):
        self.i3d.reset_parameters(generator)
        self.head.reset_parameters(generator)

    def load_backbone(self, state_dict) -> None:
        """Load an I3D checkpoint in the reference's key layout into the
        backbone; its logits head (for Kinetics' classes) is dropped."""
        self.i3d.load_state_dict(without_logits(state_dict))

    def features(self, clips: torch.Tensor, *, train: bool) -> torch.Tensor:
        """``[B, T, feature_dim]`` backbone features of ``clips``."""
        if not self.freeze_backbone:
            return self.i3d(clips, train=train)
        with torch.no_grad():
            if not self.feat_chunk:
                return self.i3d(clips, train=False)
            b, t = clips.shape[:2]
            if (b * t) % self.feat_chunk:
                raise ValueError(
                    f"feat_chunk={self.feat_chunk} must divide B*T={b * t}"
                )
            folded = clips.reshape((b * t,) + clips.shape[2:])
            out = [self.i3d(chunk, train=False)
                   for chunk in folded.split(self.feat_chunk)]
            return torch.cat(out).reshape(b, t, -1)

    def forward(self, clips: torch.Tensor, *, train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        feats = self.features(clips, train=train)
        # [T, B, F]: the head in f32 (f64 behind an f64 backbone)
        feats = feats.transpose(0, 1).to(
            torch.promote_types(feats.dtype, torch.float32))
        return self.head(feats, train=train, generator=generator)
