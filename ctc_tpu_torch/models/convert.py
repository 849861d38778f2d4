"""Carry ``ctc_tpu`` LSTM-head weights into the port.

The flax trees arrive as nested dicts of numpy arrays, so this module needs
nothing of JAX.  Dense kernels are ``[in, out]`` in flax and ``[out, in]`` in
``nn.Linear``; the recurrent kernel keeps its ``[hidden, 4 * hidden]``
orientation in both.
"""

from __future__ import annotations

import numpy as np
import torch


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def lstm_head_from_jax(params, batch_stats) -> dict[str, torch.Tensor]:
    """``state_dict`` of :class:`ctc_tpu_torch.models.lstm.LSTMHead` from the
    ``params`` / ``batch_stats`` trees of ``ctc_tpu.models.LSTMHead``."""
    fh = params["feature_head"]
    bn_stats = batch_stats["feature_head"]["bn"]
    return {
        "feature_head.proj.weight": _t(fh["proj"]["kernel"]).T.contiguous(),
        "feature_head.proj.bias": _t(fh["proj"]["bias"]),
        "feature_head.bn.weight": _t(fh["bn"]["scale"]),
        "feature_head.bn.bias": _t(fh["bn"]["bias"]),
        "feature_head.bn.running_mean": _t(bn_stats["mean"]),
        "feature_head.bn.running_var": _t(bn_stats["var"]),
        "input_gates.weight": _t(params["input_gates"]["kernel"]).T.contiguous(),
        "input_gates.bias": _t(params["input_gates"]["bias"]),
        "recurrent_kernel": _t(params["recurrent_kernel"]),
    }
