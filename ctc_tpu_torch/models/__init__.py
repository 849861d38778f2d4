"""Models: the LSTM head over clip features, the I3D and TimeSformer
backbones, the pixels models that join a backbone to the head, and the
ST-graph energy model and its criterion."""

from ctc_tpu_torch.models.convert import (
    i3d_from_jax,
    i3d_lstm_from_jax,
    lstm_head_from_jax,
    stgraph_from_jax,
)
from ctc_tpu_torch.models.i3d import (
    InceptionI3d,
    InceptionModule,
    Unit3D,
    full_f32_precision,
)
from ctc_tpu_torch.models.i3d_lstm import (
    I3DLSTM,
    PixelsLSTM,
    TimeSformerLSTM,
)
from ctc_tpu_torch.models.lstm import (
    FeatureHead,
    LSTMHead,
    TemporalBatchNorm,
    sync_batch_norm,
)
from ctc_tpu_torch.models.stgraph import (
    MessageStore,
    STGraphBase,
    STGraphCriterion,
    mean_field_messages,
    winsmooth,
)
from ctc_tpu_torch.models.timesformer import TimeSformer

__all__ = ["FeatureHead", "I3DLSTM", "InceptionI3d", "InceptionModule",
           "LSTMHead", "MessageStore", "PixelsLSTM", "STGraphBase",
           "STGraphCriterion", "TemporalBatchNorm", "TimeSformer",
           "TimeSformerLSTM", "Unit3D", "full_f32_precision",
           "i3d_from_jax", "i3d_lstm_from_jax", "lstm_head_from_jax",
           "mean_field_messages", "stgraph_from_jax", "sync_batch_norm",
           "winsmooth"]
