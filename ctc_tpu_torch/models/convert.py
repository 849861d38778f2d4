"""Carry ``ctc_tpu`` weights into the port: the LSTM head, the I3D backbone,
the pixels model that joins them, and the ST-graph model.

The flax trees arrive as nested dicts of numpy arrays, so this module needs
nothing of JAX.  Dense kernels are ``[in, out]`` in flax and ``[out, in]`` in
``nn.Linear``; the recurrent kernel keeps its ``[hidden, 4 * hidden]``
orientation in both.  Conv kernels are DHWIO in flax and OIDHW in
``nn.Conv3d``; flax's BatchNorm ``scale`` is torch's ``weight``.
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


def i3d_from_jax(params, batch_stats) -> dict[str, torch.Tensor]:
    """``state_dict`` of :class:`ctc_tpu_torch.models.i3d.InceptionI3d` from
    the ``params`` / ``batch_stats`` trees of ``ctc_tpu``'s
    ``InceptionI3d`` (the inverse of its ``convert_torch_state_dict``);
    ``num_batches_tracked`` starts at 0."""
    out = {}

    def walk(p, s, prefix):
        for name, node in p.items():
            if name == "conv3d":
                out[prefix + "conv3d.weight"] = _t(
                    node["kernel"]).permute(4, 3, 0, 1, 2).contiguous()
                if "bias" in node:
                    out[prefix + "conv3d.bias"] = _t(node["bias"])
            elif name == "bn":
                stats = s["bn"]
                out[prefix + "bn.weight"] = _t(node["scale"])
                out[prefix + "bn.bias"] = _t(node["bias"])
                out[prefix + "bn.running_mean"] = _t(stats["mean"])
                out[prefix + "bn.running_var"] = _t(stats["var"])
                out[prefix + "bn.num_batches_tracked"] = torch.zeros(
                    (), dtype=torch.long)
            else:
                walk(node, s.get(name, {}), prefix + name + ".")

    walk(params, batch_stats, "")
    return out


def i3d_lstm_from_jax(params, batch_stats) -> dict[str, torch.Tensor]:
    """``state_dict`` of :class:`ctc_tpu_torch.models.i3d_lstm.I3DLSTM`
    from the trees of ``ctc_tpu``'s ``I3DLSTM`` (subtrees ``i3d`` and
    ``head``)."""
    backbone = i3d_from_jax(params["i3d"], batch_stats.get("i3d", {}))
    head = lstm_head_from_jax(params["head"], batch_stats["head"])
    return {**{"i3d." + k: v for k, v in backbone.items()},
            **{"head." + k: v for k, v in head.items()}}


def stgraph_from_jax(params) -> dict[str, torch.Tensor]:
    """``state_dict`` of :class:`ctc_tpu_torch.models.stgraph.STGraphBase`
    from the ``params`` tree of ``ctc_tpu``'s ``STGraphBase`` (it has no
    ``batch_stats``): its top-level Dense layers by name, each pair head's
    ``a_h`` / ``a_o`` / ``b_h`` / ``b_o`` under ``pairs.<pair>``."""
    def dense(prefix, node):
        return {prefix + "weight": _t(node["kernel"]).T.contiguous(),
                prefix + "bias": _t(node["bias"])}

    out = {}
    for name, node in params.items():
        if "kernel" in node:
            out.update(dense(name + ".", node))
        else:
            for layer, sub in node.items():
                out.update(dense(f"pairs.{name}.{layer}.", sub))
    return out
