"""The frozen counts against counts made by hand, and the I3D's
convolutions and BatchNorm against the shapes a forward of the reference
actually produces."""

import math

import pytest
import torch

from benchmark import counts
from benchmark.reference import i3d_lstm, lstm_head


def test_first_convolution_by_hand():
    # Conv3d_1a_7x7: 10 x 224 x 224 in, stride 2 -> 5 x 112 x 112 x 64
    # out, 3 x 7 x 7 x 7 = 1029 multiply-adds each
    macs = 64 * 5 * 112 * 112 * 1029
    assert macs == 4_130_488_320
    first_only = i3d_lstm.i3d_parts(1)["conv"] - i3d_lstm.i3d_parts(1)[
        "conv_dgrad"]
    assert first_only == 2 * macs


def test_head_by_hand():
    # 100 rows: proj 2*100*1024*33, two 33 x 132 products, BatchNorm 5 an
    # element; backward: each product's weight gradient and the two
    # recurrent products' input gradients
    forward = 6_758_400 + 871_200 + 871_200 + 16_500
    backward = 6_758_400 + 2 * 871_200 + 2 * 871_200 + 2 * 16_500
    assert lstm_head.head_flops(100, 1024, 33) == forward + backward
    assert lstm_head.head_flops(100, 1024, 33, input_grad=True) == (
        forward + backward + 6_758_400)


def test_lattice_by_hand():
    work = counts.lattice_bytes_ops(10, 10, 10)
    assert work == {"forward": (8120, 8000), "backward": (8120, 17000)}
    assert counts.least_seconds(8120, 8000, "NVIDIA H100 80GB HBM3") == (
        pytest.approx(8120 / 3.35e12))
    assert counts.peaks("NVIDIA H100 PCIe")["hbm"] == 2.0e12


def test_i3d_convolutions_and_batchnorm_match_a_forward(monkeypatch):
    seen = {"macs": 0, "elems": 0}
    conv3d = torch.nn.functional.conv3d

    def counting(x, w, *args, **kwargs):
        out = conv3d(x, w, *args, **kwargs)
        seen["macs"] += out.numel() * math.prod(w.shape[1:])
        seen["elems"] += out.numel()
        return out

    monkeypatch.setattr(torch.nn.functional, "conv3d", counting)
    w = {k: (torch.ones(s) if "running_var" in k or k.endswith("bn.weight")
             else torch.zeros(s) if len(s) == 1
             else torch.randn(s) / math.sqrt(math.prod(s[1:])))
         for k, s in i3d_lstm.i3d_shapes().items()}
    with torch.no_grad():
        out = i3d_lstm.i3d_features(w, torch.zeros((1, 10, 224, 224, 3)),
                                    train=False)
    assert out.shape == (1, 1024)
    parts = i3d_lstm.i3d_parts(1)
    assert parts["conv"] == 2 * seen["macs"]
    assert parts["bn"] == 2 * seen["elems"]
    assert i3d_lstm.i3d_parts(3)["conv"] == 3 * parts["conv"]
    frozen = i3d_lstm.i3d_flops(100)
    assert frozen == pytest.approx(100 * (parts["conv"] + parts["pool"]
                                          + parts["bn"]))
    # finetuned: the forward, the weight gradients and every input
    # gradient but the first convolution's (2 x 4130488320 a clip)
    p100 = i3d_lstm.i3d_parts(100, finetune=True)
    assert p100["conv"] - p100["conv_dgrad"] == 100 * 2 * 4_130_488_320
    assert i3d_lstm.i3d_flops(100, finetune=True) == pytest.approx(
        3 * p100["conv"] - 100 * 2 * 4_130_488_320 + p100["pool"]
        + p100["pool_inputs"] + 3 * p100["bn"])
