"""Models: the LSTM head over I3D clip features."""

from ctc_tpu_torch.models.convert import lstm_head_from_jax
from ctc_tpu_torch.models.lstm import FeatureHead, LSTMHead, TemporalBatchNorm

__all__ = ["FeatureHead", "LSTMHead", "TemporalBatchNorm", "lstm_head_from_jax"]
