"""ctc_tpu_torch's decoders against ctc_tpu's, on the CPU: greedy collapse
and Viterbi alignment exactly, prefix beam search to the best beam (its
prefix exactly, its score to 1e-5), the window decode and alignment of the
evaluation path from the same weights (carried by ``lstm_head_from_jax``),
and the CLI's refusal of a decode flag the loss cannot serve.
"""

import csv
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ctc_tpu import decode as jdecode
from ctc_tpu.data import synthetic_feature_batches
from ctc_tpu.eval import video as jvideo
from ctc_tpu.models import LSTMHead as JaxLSTMHead
from ctc_tpu_torch import decode as tdecode
from ctc_tpu_torch.cli.main import main
from ctc_tpu_torch.eval import video as tvideo
from ctc_tpu_torch.models import LSTMHead, lstm_head_from_jax
from ctc_tpu_torch.parallel import make_seq_mesh

SCORE_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("blank", [0, -1])
def test_collapse_repeats_matches_jax(blank):
    rng = np.random.default_rng(1)
    labels = rng.integers(0, 4, size=(6, 15)).astype(np.int32)
    lengths = np.array([15, 9, 1, 0, 15, 4])
    want = jdecode.collapse_repeats(jnp.asarray(labels), jnp.asarray(lengths),
                                    blank)
    got = tdecode.collapse_repeats(torch.tensor(labels),
                                   torch.tensor(lengths), blank)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("blank", [0, -1])
def test_greedy_decode_matches_jax(blank):
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((12, 5, 4)).astype(np.float32)
    lengths = np.array([12, 7, 3, 1, 10])
    want = jdecode.greedy_decode(jnp.asarray(logits), jnp.asarray(lengths),
                                 blank=blank)
    got = tdecode.greedy_decode(torch.tensor(logits), torch.tensor(lengths),
                                blank=blank)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_viterbi_align_matches_jax():
    rng = np.random.default_rng(3)
    T, B, L = 14, 6, 5
    em = rng.standard_normal((T, B, L)).astype(np.float32)
    in_len = np.array([14, 9, 5, 14, 1, 11])
    tgt_len = np.array([5, 3, 5, 1, 1, 4])
    ali_j, score_j = jdecode.viterbi_align(
        jnp.asarray(em), jnp.asarray(in_len), jnp.asarray(tgt_len))
    ali_t, score_t = tdecode.viterbi_align(
        torch.tensor(em), torch.tensor(in_len), torch.tensor(tgt_len))
    assert ali_t.dtype == torch.int32
    np.testing.assert_array_equal(ali_t.numpy(), np.asarray(ali_j))
    np.testing.assert_array_equal(score_t.numpy(), np.asarray(score_j))


@pytest.mark.parametrize(
    "beam_width,prune,max_len",
    [(4, 8, None), (8, 3, None), (4, 5, 3)],
    ids=["default-prune", "narrow-prune", "short-max-len"],
)
def test_beam_search_best_beam_matches_jax(beam_width, prune, max_len):
    rng = np.random.default_rng(beam_width * 10 + prune)
    T, B, C = 12, 4, 6
    logits = (2.0 * rng.standard_normal((T, B, C))).astype(np.float32)
    lengths = np.array([12, 8, 1, 5])
    kw = dict(beam_width=beam_width, prune=prune, blank=0, max_len=max_len)
    p_j, l_j, s_j = jdecode.beam_search_decode(
        jnp.asarray(logits), jnp.asarray(lengths), **kw)
    p_t, l_t, s_t = tdecode.beam_search_decode(
        torch.tensor(logits), torch.tensor(lengths), **kw)
    assert p_t.shape == p_j.shape and l_t.shape == l_j.shape
    np.testing.assert_array_equal(l_t[:, 0].numpy(), np.asarray(l_j[:, 0]))
    np.testing.assert_array_equal(p_t[:, 0].numpy(), np.asarray(p_j[:, 0]))
    np.testing.assert_allclose(s_t[:, 0].numpy(), np.asarray(s_j[:, 0]),
                               **SCORE_TOL)
    assert np.all(np.diff(s_t.numpy(), axis=1) <= 0)  # best first


def _carried_models(loss, c=9, f=16, temporal=8):
    """A JAX LSTM head, the port's with the same weights, and batches."""
    batches = synthetic_feature_batches(
        num_batches=2, batch_size=4, temporal=temporal, feat_dim=f,
        num_classes=c, max_path=(temporal // 2 if loss == "blank" else None),
        seed=5)
    jmodel = JaxLSTMHead(hidden=c, dropout_rate=0.0)
    variables = jmodel.init(jax.random.PRNGKey(4),
                            jnp.zeros((temporal, 4, f)), train=False)
    state = types.SimpleNamespace(params=variables["params"],
                                  batch_stats=variables["batch_stats"])
    model = LSTMHead(f, c, dropout_rate=0.0)
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    model.load_state_dict(lstm_head_from_jax(np_tree(state.params),
                                             np_tree(state.batch_stats)))
    return jmodel, state, model, batches


def _rows(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


@pytest.mark.parametrize("blank,beam_width",
                         [(-1, 0), (0, 0), (0, 4)],
                         ids=["noblank-greedy", "blank-greedy", "blank-beam"])
def test_decode_windows_csv_matches_jax(tmp_path, blank, beam_width):
    jmodel, state, model, batches = _carried_models(
        "blank" if blank == 0 else "noblank")
    want = jvideo.decode_windows(jmodel, state, batches, blank=blank,
                                 beam_width=beam_width,
                                 out_csv=str(tmp_path / "jax.csv"))
    got = tvideo.decode_windows(model, batches, blank=blank,
                                beam_width=beam_width,
                                out_csv=str(tmp_path / "torch.csv"))
    rows = _rows(tmp_path / "torch.csv")
    assert rows == _rows(tmp_path / "jax.csv")
    assert len(rows) - 1 == 8
    np.testing.assert_array_equal(got["decoded"], want["decoded"])
    np.testing.assert_array_equal(got["lengths"], want["lengths"])


def test_align_windows_csv_matches_jax(tmp_path):
    """Equal rows; the score column (a sum of f32 log-softmax emissions
    from each package's own forward pass) to 1e-5."""
    jmodel, state, model, batches = _carried_models("noblank")
    jvideo.align_windows(jmodel, state, batches, loss_kind="noblank",
                         out_csv=str(tmp_path / "jax.csv"))
    tvideo.align_windows(model, batches, loss_kind="noblank",
                         out_csv=str(tmp_path / "torch.csv"))
    want, got = _rows(tmp_path / "jax.csv"), _rows(tmp_path / "torch.csv")
    assert len(got) == len(want) == 9
    assert got[0] == want[0]
    for g, w in zip(got[1:], want[1:]):
        assert g[:3] + g[4:] == w[:3] + w[4:]
        np.testing.assert_allclose(float(g[3]), float(w[3]), **SCORE_TOL)


def test_decode_windows_refusals():
    _, _, model, batches = _carried_models("noblank")
    with pytest.raises(ValueError, match="blank"):
        tvideo.decode_windows(model, batches, blank=-1, beam_width=4)
    with pytest.raises(ValueError, match="seq_mesh"):
        tvideo.decode_windows(model, batches, blank=0, beam_width=4,
                              seq_mesh=make_seq_mesh(4, "cpu"))
    with pytest.raises(ValueError, match="blank-free"):
        tvideo.align_windows(model, batches, loss_kind="blank")


CLI = ["--dataset", "synthetic", "--extract-feat-dim", "16",
       "--batch-size", "4", "--temporal", "8", "--device", "cpu",
       "--evaluate"]


@pytest.mark.parametrize(
    "flags,match",
    [(["--decode", "--decode-beam", "4"], "blank symbol"),
     (["--loss", "blank", "--decode-align"], "blank-free")],
    ids=["beam-without-blank", "align-with-blank"],
)
def test_cli_refuses_decode_flags_before_eval(tmp_path, flags, match):
    with pytest.raises(SystemExit, match=match):
        main(CLI + ["--cache-dir", str(tmp_path)] + flags)
    # nothing ran: not even the log tee
    assert not (tmp_path / "test" / "log.txt").exists()


def test_cli_decode_align_writes_one_row_per_window(tmp_path):
    metrics = main(CLI + ["--cache-dir", str(tmp_path), "--decode-align",
                          "--decode"])
    rows = _rows(metrics["alignment_csv"])
    assert rows[0] == ["batch", "index", "input_length", "score",
                       "alignment"]
    assert len(rows) - 1 == 8 == len(_rows(metrics["decoded_csv"])) - 1
    for row in rows[1:]:
        ali = np.array([int(x) for x in row[4].split()])
        assert len(ali) == int(row[2]) and ali[0] == 0
        assert np.all(np.isin(np.diff(ali), (0, 1)))
