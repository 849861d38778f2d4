"""The plain reference agrees with the port at a small size on the CPU:
the windows and batches, the decoded frames, the I3D, the head, the loss,
and the optimizers' steps."""

import numpy as np
import pytest
import torch

from benchmark import corpus
from benchmark.reference import data as ref_data
from benchmark.reference import i3d_lstm, lstm_head
from benchmark.reference import train as ref_train
from ctc_tpu_torch.data import charades, frames
from ctc_tpu_torch.data.loading import host_shard_indices
from ctc_tpu_torch.losses.noblank import no_blank_ctc_loss
from ctc_tpu_torch.models import I3DLSTM, LSTMHead
from ctc_tpu_torch.models.i3d import InceptionI3d
from ctc_tpu_torch.train.optim import TorchStyleAdam, TorchStyleSGD


@pytest.fixture(scope="module")
def jpeg_corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus")
    return corpus.write_corpus(str(root), seed=2**31 + 3, train_videos=40,
                               val_videos=8, jpeg=True, features=False)


def _weights(model, shapes, seed=11):
    w = ref_train.initial_weights(model, shapes, seed, "cpu")
    # move BatchNorm and biases off their starting values, so the check
    # reaches every term
    g = torch.Generator().manual_seed(seed)
    return {k: (v + 0.1 * torch.randn(v.shape, generator=g)
                if v.dim() == 1 and "running_var" not in k else v)
            for k, v in w.items()}


def test_windows_and_batches_match_the_port(jpeg_corpus):
    paths = jpeg_corpus
    for split in ("train", "val"):
        labels = charades.parse_charades_csv(paths[f"{split}_file"])
        counts = {v: charades.count_frames(paths["rgb_data"], v)
                  for v in labels}
        data, _ = charades.prepare_windows(labels, counts, split, 10, 2, 2,
                                           rgb_root=paths["rgb_data"])
        ref = ref_data.train_windows(
            ref_data.parse_csv(paths[f"{split}_file"]),
            {v: ref_data.count_frames(paths["rgb_data"], v) for v in labels},
            paths["rgb_data"], temporal=10, gap=2, num_trans=2)
        assert len(ref) == len(data["ids"]) == paths["windows"][split] > 0
        for i, w in enumerate(ref):
            assert w["frames"] == data["rgb_image_paths"][i]
            np.testing.assert_array_equal(w["path"], data["v_targets"][i])
            assert w["length"] == data["v_times"][i]
            assert w["future"] == data["v_f_targets"][i]
    for seed in (0, 2**31 + 9):
        want = host_shard_indices(37, 10, shuffle=True, seed=seed)
        got = ref_data.train_batches(37, 10, seed)
        assert [list(a) for a in got] == [list(a) for a in want]


def test_decoded_frames_match_the_port(jpeg_corpus):
    anchors = ref_data.train_windows(
        ref_data.parse_csv(jpeg_corpus["train_file"]),
        {v: ref_data.count_frames(jpeg_corpus["rgb_data"], v) for v in
         ref_data.parse_csv(jpeg_corpus["train_file"])},
        jpeg_corpus["rgb_data"], temporal=10, gap=2,
        num_trans=2)[0]["frames"][:2]
    want = frames.load_window(anchors, 2, inputsize=224)
    np.testing.assert_array_equal(ref_data.window_clips(
        anchors, i3d_lstm.clip_offsets(
            {"geometry": {"gap": 2}, "stack": 10}), 224), want)


@pytest.mark.parametrize("train", [False, True])
def test_i3d_matches_the_port(train):
    shapes = i3d_lstm.i3d_shapes()
    w = _weights(i3d_lstm, shapes)
    port = InceptionI3d(num_classes=None)
    state = {k: w[k] for k in shapes}
    state.update({k: torch.zeros((), dtype=torch.long)
                  for k in port.state_dict() if k.endswith("tracked")})
    port.load_state_dict(state)
    clips = torch.randn((2, 10, 224, 224, 3),
                        generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        got = port(clips[:, None], train=train)[:, 0]
        want = i3d_lstm.i3d_features(w, clips, train=train)
    assert got.shape == want.shape == (2, 1024)
    # batch statistics as E[x^2] - E[x]^2 cancel in float32, so the two
    # orders of summation part further in training mode
    tol = (1e-3, 1e-4) if train else (1e-4, 1e-5)
    torch.testing.assert_close(got, want, rtol=tol[0], atol=tol[1])


def test_head_and_loss_match_the_port():
    shapes = lstm_head.shapes({"feature_dim": 64, "hidden": 33})
    w = _weights(lstm_head, shapes)
    port = LSTMHead(64, 33, dropout_rate=0.3)
    port.load_state_dict({k[5:]: v for k, v in w.items()})
    g = torch.Generator().manual_seed(2)
    feats = torch.randn((10, 6, 64), generator=g)
    paths = torch.randint(0, 33, (6, 10), generator=g)
    lengths = torch.tensor([10, 3, 1, 7, 5, 2])
    paths[torch.arange(10)[None, :] >= lengths[:, None]] = -1
    got = port(feats, train=True, generator=torch.Generator().manual_seed(5))
    mask = torch.empty((10, 6, 33)).bernoulli_(
        0.7, generator=torch.Generator().manual_seed(5))
    want = lstm_head.head_logits({k[5:]: v for k, v in w.items()}, feats,
                                 mask, 0.7)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    logits = want.detach().requires_grad_(True)
    ref_loss = lstm_head.noblank_loss(logits, paths, lengths)
    port_logits = want.detach().requires_grad_(True)
    port_loss = no_blank_ctc_loss(port_logits, paths,
                                  torch.full((6,), 10), lengths)
    torch.testing.assert_close(port_loss, ref_loss, rtol=1e-5, atol=1e-5)
    ref_loss.backward()
    port_loss.backward()
    torch.testing.assert_close(port_logits.grad, logits.grad, rtol=2e-3,
                               atol=2e-5)


@pytest.mark.parametrize("finetune", [False, True])
def test_optimizer_steps_match_the_port(finetune):
    """Three steps of the recipe's optimizers on a loss that is a plain
    function of the parameters."""
    g = torch.Generator().manual_seed(3)
    head = {"head.a": torch.randn(5, 4, generator=g),
            "head.b": torch.randn(4, generator=g)}
    body = {"i3d.c": torch.randn(3, 3, generator=g)} if finetune else {}
    start = {**head, **body}
    targets = [{k: torch.randn(v.shape, generator=g) for k, v in start.items()}
               for _ in range(3)]

    def loss_of(p, step):
        return sum(((p[k] - targets[step][k]) ** 3).sum() for k in p)

    # the port's optimizer
    params = {k: v.clone().requires_grad_(True) for k, v in start.items()}
    sched = lambda count: 1e-2  # noqa: E731
    sgd = (TorchStyleSGD([params["i3d.c"]], sched, momentum=0.9,
                         weight_decay=1e-4) if finetune else None)
    opt = TorchStyleAdam([params["head.a"], params["head.b"]], 1e-4, sgd=sgd)
    for step in range(3):
        opt.begin(torch.tensor(step))
        loss_of(params, step).backward()
        opt.step(torch.tensor(step), sched(step))
    # the reference's arithmetic on the same loss
    p = {k: v.clone() for k, v in start.items()}
    m = {k: torch.zeros_like(v) for k, v in head.items()}
    v2 = {k: torch.zeros_like(v) for k, v in head.items()}
    tr = {k: torch.zeros_like(v) for k, v in body.items()}
    for step in range(3):
        q = {k: x.clone().requires_grad_(True) for k, x in p.items()}
        grads = torch.autograd.grad(loss_of(q, step), list(q.values()))
        for (k, x), gr in zip(p.items(), grads):
            gr = gr + 1e-4 * x
            if k in m:
                m[k] = 0.9 * m[k] + 0.1 * gr
                v2[k] = 0.999 * v2[k] + 0.001 * gr * gr
                mh = m[k] / (1 - 0.9 ** (step + 1))
                vh = v2[k] / (1 - 0.999 ** (step + 1))
                p[k] = x - 1e-2 * mh / (vh.sqrt() + 1e-8)
            else:
                tr[k] = gr + 0.9 * tr[k]
                p[k] = x - 1e-2 * tr[k]
    for k in start:
        torch.testing.assert_close(params[k].detach(), p[k], rtol=1e-5,
                                   atol=1e-6)


def test_reference_steps_match_the_port_model():
    """:func:`train_steps` against the port's model and optimizer stepped
    by hand on the same batch, head on features."""
    shapes = lstm_head.shapes({"feature_dim": 32, "hidden": 33})
    w = ref_train.initial_weights(lstm_head, shapes, 4, "cpu")
    g = torch.Generator().manual_seed(6)
    batches = []
    for _ in range(3):
        lengths = torch.randint(1, 6, (4,), generator=g)
        paths = torch.randint(0, 33, (4, 10), generator=g)
        paths[torch.arange(10)[None, :] >= lengths[:, None]] = -1
        batches.append({"feats": torch.randn((4, 10, 32), generator=g),
                        "paths": paths, "target_lengths": lengths})
    ref = ref_train.train_steps(lstm_head, w, batches, finetune=False,
                                seed=9,
                                lr=1e-3, weight_decay=1e-4, momentum=0.9,
                                dropout=0.3)
    model = LSTMHead(32, 33, dropout_rate=0.3)
    model.load_state_dict({k[5:]: v for k, v in w.items()})
    opt = TorchStyleAdam(list(model.parameters()), 1e-4)
    gen = torch.Generator().manual_seed(9)
    losses = []
    for step, b in enumerate(batches):
        opt.begin(torch.tensor(step))
        logits = model(b["feats"].transpose(0, 1), train=True, generator=gen)
        loss = no_blank_ctc_loss(logits, b["paths"], torch.full((4,), 10),
                                 b["target_lengths"])
        loss.backward()
        losses.append(loss.item())
        opt.step(torch.tensor(step), 1e-3)
    np.testing.assert_allclose(losses, ref["losses"], rtol=1e-5)
    # a leaf whose gradient is nought to rounding (the projection's bias
    # before BatchNorm) moves under Adam by round-off alone
    still = ref_train.compare(ref, ref, w)["still_leaves"]
    assert still == ["head.feature_head.proj.bias"]
    for name, p in model.named_parameters():
        if "head." + name not in still:
            torch.testing.assert_close(p.detach(),
                                       ref["params"]["head." + name],
                                       rtol=1e-4, atol=1e-6)


def test_pixels_model_names_are_the_references():
    model = I3DLSTM(hidden=33)
    names = {k for k in model.state_dict() if not k.endswith("tracked")}
    want = {f"i3d.{k}" for k in i3d_lstm.i3d_shapes()}
    want |= {f"head.{k}" for k in lstm_head.head_shapes(1024, 33)}
    assert names == want
    for k, t in model.state_dict().items():
        if k.startswith("i3d.") and not k.endswith("tracked"):
            assert tuple(t.shape) == i3d_lstm.i3d_shapes()[k[4:]]
