"""ctc_tpu_torch's sequence-parallel lattice against ctc_tpu's, on the CPU:
the two shard ops against the boundary-init Pallas ops (interpret mode),
the 4-shard pipeline against ``make_seq_sharded_lattice_nll`` in every
mode, the sharded greedy decode, the seq-parallel trainer and the CLI; and,
on a card, the four boundary kernels against their plain versions.

JAX is imported inside the helpers, not at the top: the card's machine has
no JAX, and the ``cuda`` tests below run there on their own
(``python -m pytest tests/test_torch_seq_lattice.py -m cuda``).

Tolerances: rtol/atol 1e-5 for values and gradients, the JAX seq suite's
own (tests/test_seq_lattice.py): both sides are f32 and differ in the libm
of exp/log1p and in summation order.  The trainer's losses are held to rtol
1e-4 (tests/test_seq_lattice.py's trainer test): the 1024-deep sums of the
model run in another order on each side and Adam compounds them.
"""

import csv

import numpy as np
import pytest
import torch

from ctc_tpu_torch import losses as tlosses
from ctc_tpu_torch.cli.main import main
from ctc_tpu_torch.eval import video as tvideo
from ctc_tpu_torch.losses.blank import blank_emissions_and_skip
from ctc_tpu_torch.ops import blank_lattice_cuda as bl
from ctc_tpu_torch.ops import dispatch
from ctc_tpu_torch.ops import lattice_cuda as lc
from ctc_tpu_torch.ops.logspace import BLANK_NEG, NEG_SENTINEL
from ctc_tpu_torch.parallel import (
    make_mesh,
    make_seq_mesh,
    make_seq_sharded_greedy_decode,
    make_seq_sharded_lattice_nll,
    make_seq_sharded_loss,
)

TOL = dict(rtol=1e-5, atol=1e-5)
TRAIN_LOSS_TOL = dict(rtol=1e-4, atol=1e-5)
# the card's kernels against the plain version: the port's kernel tolerances
LOSS_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=2e-3, atol=2e-5)
N_SHARDS = 4


def _jax_mesh():
    import jax
    from jax.sharding import Mesh

    return Mesh(np.asarray(jax.devices()[:N_SHARDS]), ("seq",))


# ---------------------------------------------------------------------------
# the shard ops
# ---------------------------------------------------------------------------

# local input lengths below 1, inside the shard and above it (t_s = 6)
LOCAL_LENGTHS = [-3, 0, 1, 3, 6, 7, 12, 6]
SHARD_CASES = {
    "shard0": (6, 8, 10, "init", LOCAL_LENGTHS),
    "interior": (6, 8, 10, "random", LOCAL_LENGTHS),
    "L1": (5, 4, 1, "random", [1, 5, 9, 0]),
}


def _shard_case(seed, T, B, width, rows, lengths, init_row):
    rng = np.random.default_rng(seed)
    em = (rng.standard_normal((T, B, width)) - 1.0).astype(np.float32)
    if rows == "init":
        neg = NEG_SENTINEL if init_row is lc.noblank_alpha_init else BLANK_NEG
        r0 = init_row(B, width).numpy()
        r1 = np.full((B, width), neg, np.float32)
    else:
        r0, r1 = (
            (3.0 * rng.standard_normal((B, width)) - 8.0).astype(np.float32)
            for _ in range(2))
        # unreached cells at the sentinel, on half the samples
        neg = NEG_SENTINEL if init_row is lc.noblank_alpha_init else BLANK_NEG
        r0[::2, -2:] = r1[::2, -2:] = neg
    inl = np.asarray(lengths, np.int32)
    d_final = rng.standard_normal(B).astype(np.float32)
    d_boundary = rng.standard_normal((B, width)).astype(np.float32)
    return em, r0, r1, inl, d_final, d_boundary


def _torch_vjp(op, em, r0, r1, extra, d_final, d_boundary):
    """``op(em, r0, r1, *extra) -> (final, boundary)`` on the CPU: values
    and the vjp with respect to em and both init rows."""
    e, a, b = (torch.tensor(x, requires_grad=True) for x in (em, r0, r1))
    final, boundary = op(e, a, b, *extra)
    ((final * torch.tensor(d_final)).sum()
     + (boundary * torch.tensor(d_boundary)).sum()).backward()
    return [x.detach().numpy() for x in (final, boundary, e.grad, a.grad,
                                         b.grad)]


def _jax_vjp(op, em, r0, r1, extra, d_final, d_boundary):
    """The JAX shard op in the pipeline's tlb layout; its boundary row is
    padded to ``boundary_width`` and comes back cut to the lattice width."""
    import jax
    import jax.numpy as jnp

    width = em.shape[2]

    def f(e, a, b):
        final, boundary = op(jnp.transpose(e, (0, 2, 1)), a, b, *extra,
                             "tlb", True, None)
        return final, boundary

    (final, boundary), vjp = jax.vjp(f, *map(jnp.asarray, (em, r0, r1)))
    pad = boundary.shape[1] - width
    g_em, g_a, g_b = vjp((jnp.asarray(d_final),
                          jnp.pad(jnp.asarray(d_boundary), ((0, 0), (0, pad)))))
    return [np.asarray(x) for x in (final, boundary[:, :width], g_em, g_a,
                                    g_b)]


@pytest.mark.parametrize("case", list(SHARD_CASES))
def test_noblank_shard_op_matches_jax(case):
    from ctc_tpu.ops.lattice_pallas import noblank_shard_lattice_pallas

    T, B, L, rows, lengths = SHARD_CASES[case]
    em, r0, r1, inl, d_final, d_boundary = _shard_case(
        1, T, B, L, rows, lengths, lc.noblank_alpha_init)
    tgt = np.random.default_rng(2).integers(1, L + 1, size=B).astype(np.int32)
    tgt[0] = L
    got = _torch_vjp(lc.noblank_shard_lattice_plain, em, r0, r1,
                     (torch.tensor(inl), torch.tensor(tgt)), d_final,
                     d_boundary)
    want = _jax_vjp(noblank_shard_lattice_pallas, em, r0, r1,
                    (inl, tgt), d_final, d_boundary)
    for name, g, w in zip(("final", "boundary", "d em", "d stay0", "d adv0"),
                          got, want):
        np.testing.assert_allclose(g, w, err_msg=name, **TOL)
    # a shard that does not own a sample's final cell gives 0 there
    assert np.all(got[0][(inl < 1) | (inl > T)] == 0.0)


BLANK_SHARD_CASES = {
    **SHARD_CASES,
    "repeats_and_zero_length": (6, 8, 4, "random", LOCAL_LENGTHS),
}


def _blank_targets(seed, B, L, repeats):
    rng = np.random.default_rng(seed)
    targets = rng.integers(1, 7, size=(B, max(L, 1))).astype(np.int32)
    tgt = rng.integers(1, L + 1, size=B).astype(np.int32)
    if repeats:
        targets[:, 1::2] = targets[:, 0::2][:, : targets[:, 1::2].shape[1]]
        tgt[1::3] = 0
    tgt[0] = L
    return targets, tgt


@pytest.mark.parametrize("case", list(BLANK_SHARD_CASES))
def test_blank_shard_op_matches_jax(case):
    from ctc_tpu.ops.blank_lattice_pallas import blank_shard_lattice_pallas

    T, B, L, rows, lengths = BLANK_SHARD_CASES[case]
    S = 2 * L + 1
    targets, tgt = _blank_targets(3, B, L, case.startswith("repeats"))
    logits = torch.tensor(np.random.default_rng(4).standard_normal(
        (T, B, 7)).astype(np.float32))
    _, skip = blank_emissions_and_skip(logits, torch.tensor(targets), 0)
    em, r0, r1, inl, d_final, d_boundary = _shard_case(
        5, T, B, S, rows, lengths, bl.blank_alpha_init)
    got = _torch_vjp(bl.blank_shard_lattice_plain, em, r0, r1,
                     (skip, torch.tensor(inl), torch.tensor(tgt)), d_final,
                     d_boundary)
    want = _jax_vjp(
        lambda e, a, b, *rest: blank_shard_lattice_pallas(
            e, a, b, skip.numpy(), *rest),
        em, r0, r1, (inl, tgt), d_final, d_boundary)
    for name, g, w in zip(("final", "boundary", "d em", "d init0",
                           "d skip0"), got, want):
        np.testing.assert_allclose(g, w, err_msg=name, **TOL)


def test_shard_op_of_whole_lattice_is_the_unsharded_nll():
    """One shard holding all of T, from the standard init rows, is the
    unsharded lattice: final = -nll, and the same gradient."""
    rng = np.random.default_rng(6)
    T, B, L = 9, 5, 6
    em = torch.tensor((rng.standard_normal((T, B, L)) - 1).astype(np.float32))
    inl = torch.tensor([9, 4, 1, 9, 7])
    tgt = torch.tensor([6, 3, 1, 2, 6])
    e1, e2 = em.clone().requires_grad_(), em.clone().requires_grad_()
    stay0 = lc.noblank_alpha_init(B, L)
    final, _ = dispatch.shard_lattice(e1, stay0, torch.full_like(
        stay0, NEG_SENTINEL), inl, tgt)
    nll = dispatch.lattice_nll(e2, inl, tgt)
    final.sum().backward()
    (-nll).sum().backward()
    torch.testing.assert_close(final, -nll.detach(), rtol=0, atol=0)
    torch.testing.assert_close(e1.grad, e2.grad, rtol=0, atol=0)


def test_shard_ops_validate_operands():
    em = torch.zeros((4, 3, 5))
    lens = torch.ones(3, dtype=torch.int32)
    with pytest.raises(ValueError, match="stay0"):
        lc.noblank_shard_lattice_cuda(em, torch.zeros((3, 4)),
                                      torch.zeros((3, 5)), lens, lens)
    with pytest.raises(ValueError, match="CUDA"):
        dispatch.blank_shard_lattice(em, torch.zeros((3, 5)),
                                     torch.zeros((3, 5)),
                                     torch.zeros((3, 5), dtype=torch.bool),
                                     lens, lens, implementation="cuda")
    # the launchers take CUDA tensors only: no quiet CPU run
    with pytest.raises(ValueError, match="CUDA"):
        lc.noblank_shard_forward_kernel(em, lens, lens, torch.zeros((3, 5)),
                                        torch.zeros((3, 5)))


# ---------------------------------------------------------------------------
# the pipeline
# ---------------------------------------------------------------------------

T_SEQ, B_SEQ, C_SEQ, L_SEQ = 32, 8, 9, 6
# finals on every shard (T/4 = 8 frames each)
IN_LEN = np.array([1, 7, 8, 9, 16, 17, 25, 32])


def _pipeline_inputs(mode):
    rng = np.random.default_rng(7)
    logits = rng.standard_normal((T_SEQ, B_SEQ, C_SEQ)).astype(np.float32)
    if mode == "noblank":
        x = (rng.standard_normal((T_SEQ, B_SEQ, L_SEQ)) - 1).astype(
            np.float32)
        paths = None
    elif mode == "binary":
        x = logits
        paths = (rng.random((B_SEQ, L_SEQ, C_SEQ)) < 0.3).astype(np.float32)
    else:
        x = logits
        paths = rng.integers(1 if mode == "blank" else 0, C_SEQ,
                             size=(B_SEQ, L_SEQ)).astype(np.int32)
    if mode == "blank":
        # repeated labels, and every target feasible: 2 L + 1 <= T_b
        paths[:, 1::2] = paths[:, 0::2]
        tgt = np.minimum(rng.integers(0, L_SEQ + 1, size=B_SEQ),
                         (IN_LEN - 1) // 2)
    else:
        tgt = np.minimum(rng.integers(1, L_SEQ + 1, size=B_SEQ), IN_LEN)
    cot = rng.standard_normal(B_SEQ).astype(np.float32)
    return x, paths, IN_LEN, tgt.astype(np.int32), cot


_JAX_PIPELINE = {}


def _jax_pipeline(mode, implementation):
    """JAX's 4-shard pipeline: per-sample NLL and the gradient of
    ``sum(nll * cot)`` (computed once per mode and implementation)."""
    key = (mode, implementation)
    if key not in _JAX_PIPELINE:
        import jax
        import jax.numpy as jnp

        from ctc_tpu.parallel import seq_lattice as jseq

        mesh = _jax_mesh()
        x, paths, inl, tgt, cot = _pipeline_inputs(mode)
        fn = jseq.make_seq_sharded_lattice_nll(
            mesh, mode=mode, implementation=implementation,
            interpret=(implementation == "pallas"))
        args = ((inl, tgt) if paths is None else (paths, inl, tgt))
        args = tuple(map(jnp.asarray, args))

        def f(v):
            nll = fn(jseq.shard_time_axis(v, mesh), *args)
            return jnp.sum(nll * jnp.asarray(cot)), nll

        (_, nll), g = jax.value_and_grad(f, has_aux=True)(jnp.asarray(x))
        _JAX_PIPELINE[key] = (np.asarray(nll), np.asarray(g))
    return _JAX_PIPELINE[key]


def _torch_pipeline(fn, mode):
    x, paths, inl, tgt, cot = _pipeline_inputs(mode)
    v = torch.tensor(x, requires_grad=True)
    args = [torch.tensor(a) for a in (inl, tgt)]
    if paths is not None:
        args = [torch.tensor(paths)] + args
    nll = fn(v, *args)
    (nll * torch.tensor(cot)).sum().backward()
    return nll.detach().numpy(), v.grad.numpy()


def _unsharded_nll(mode):
    if mode == "noblank":
        return lambda em, inl, tgt: dispatch.lattice_nll(em, inl, tgt)
    loss = {"noblank_logits": tlosses.no_blank_ctc_loss,
            "binary": tlosses.no_blank_binary_ctc_loss,
            "blank": tlosses.ctc_loss}[mode]
    return lambda x, p, inl, tgt: loss(x, p, inl, tgt, reduction="none")


@pytest.mark.parametrize("m", [4, 8])
@pytest.mark.parametrize("mode", ["noblank", "noblank_logits", "binary",
                                  "blank"])
def test_pipeline_matches_jax(mode, m):
    """Value and gradient against JAX's XLA-scan pipeline and against the
    port's unsharded loss, with finals owned by every shard."""
    fn = make_seq_sharded_lattice_nll(make_seq_mesh(N_SHARDS, "cpu"),
                                      mode=mode, num_microbatches=m)
    nll, g = _torch_pipeline(fn, mode)
    want_nll, want_g = _jax_pipeline(mode, "xla")
    np.testing.assert_allclose(nll, want_nll, **TOL)
    np.testing.assert_allclose(g, want_g, **TOL)
    ref_nll, ref_g = _torch_pipeline(_unsharded_nll(mode), mode)
    np.testing.assert_allclose(nll, ref_nll, **TOL)
    np.testing.assert_allclose(g, ref_g, **TOL)


@pytest.mark.parametrize("mode", ["noblank_logits", "blank"])
def test_pipeline_matches_jax_pallas_shards(mode):
    """Against JAX's pipeline of boundary-init Pallas shards (interpret
    mode), one case per lattice family."""
    fn = make_seq_sharded_lattice_nll(make_seq_mesh(N_SHARDS, "cpu"),
                                      mode=mode)
    nll, g = _torch_pipeline(fn, mode)
    want_nll, want_g = _jax_pipeline(mode, "pallas")
    np.testing.assert_allclose(nll, want_nll, **TOL)
    np.testing.assert_allclose(g, want_g, **TOL)


def test_pipeline_refusals():
    mesh = make_seq_mesh(N_SHARDS, "cpu")
    em = torch.zeros((8, 6, 3))
    lens = torch.ones(6, dtype=torch.int32)
    with pytest.raises(ValueError, match="num_microbatches"):
        make_seq_sharded_lattice_nll(mesh, num_microbatches=4)(em, lens, lens)
    with pytest.raises(ValueError, match="divisible"):
        make_seq_sharded_lattice_nll(mesh)(em[:6], lens, lens)
    with pytest.raises(ValueError, match="data axis"):
        make_seq_sharded_lattice_nll(mesh, batch_axis="data")
    with pytest.raises(ValueError, match="one second axis"):
        make_mesh(data=2, model=2, seq=2, device="cpu")
    with pytest.raises(ValueError, match="lattice loss"):
        make_seq_sharded_loss(mesh, "ce")


# ---------------------------------------------------------------------------
# the sharded greedy decode
# ---------------------------------------------------------------------------


def _jax_seq_decode(logits, in_len, blank):
    import jax.numpy as jnp

    from ctc_tpu.parallel import seq_lattice as jseq

    mesh = _jax_mesh()
    fn = jseq.make_seq_sharded_greedy_decode(mesh, blank=blank)
    dec, lens = fn(jseq.shard_time_axis(jnp.asarray(logits), mesh),
                   jnp.asarray(in_len))
    return np.asarray(dec), np.asarray(lens)


def _boundary_repeat_logits():
    """Class 2 active over t = 6..10 (across the t = 8 shard boundary) and
    class 3 over t = 20..21."""
    logits = np.full((32, 2, 4), -5.0, np.float32)
    logits[6:11, :, 2] = 5.0
    logits[20:22, :, 3] = 5.0
    return logits, np.array([32, 32])


@pytest.mark.parametrize("case", ["random", "boundary_repeat"])
@pytest.mark.parametrize("blank", [0, -1])
def test_sharded_greedy_decode_matches_jax(case, blank):
    if case == "random":
        logits = np.random.default_rng(8).standard_normal(
            (32, 6, 9)).astype(np.float32)
        in_len = np.array([32, 20, 9, 1, 32, 15])
    else:
        logits, in_len = _boundary_repeat_logits()
    dec, lens = make_seq_sharded_greedy_decode(
        make_seq_mesh(N_SHARDS, "cpu"), blank=blank)(torch.tensor(logits),
                                               torch.tensor(in_len))
    want_dec, want_lens = _jax_seq_decode(logits, in_len, blank)
    np.testing.assert_array_equal(dec.numpy(), want_dec)
    np.testing.assert_array_equal(lens.numpy(), want_lens)
    if case == "boundary_repeat" and blank == 0:
        assert lens.tolist() == [2, 2] and dec[0, :2].tolist() == [2, 3]


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("loss", ["noblank", "blank"])
def test_seq_trainer_matches_unsharded_and_jax(loss):
    """Trainer(seq_parallel=4, seq_microbatches=8): three Adam steps and an
    eval step against the port's unsharded trainer and JAX's seq trainer,
    from the same weights."""
    import jax
    import jax.numpy as jnp

    from ctc_tpu.data import synthetic_feature_batches
    from ctc_tpu.models import LSTMHead as JaxLSTMHead
    from ctc_tpu.train import Trainer as JaxTrainer
    from ctc_tpu_torch.models import LSTMHead, lstm_head_from_jax
    from ctc_tpu_torch.train.trainer import Trainer, to_device

    T, B, F, C = 32, 8, 16, 9
    batch = synthetic_feature_batches(
        num_batches=1, batch_size=B, temporal=T, feat_dim=F, num_classes=C,
        max_path=(T // 2 if loss == "blank" else 12), seed=2)[0]
    common = dict(loss_kind=loss, lr=1e-3, seed=0)
    jtr = JaxTrainer(JaxLSTMHead(hidden=C, dropout_rate=0.0),
                     seq_parallel=4, seq_microbatches=8,
                     implementation="xla", **common)
    jstate = jtr.init_state(batch)
    weights = lstm_head_from_jax(
        *(jax.tree_util.tree_map(np.asarray, t)
          for t in (jstate.params, jstate.batch_stats)))
    trainers = {
        "seq": Trainer(LSTMHead(F, C, dropout_rate=0.0), seq_parallel=4,
                       seq_microbatches=8, device="cpu", **common),
        "plain": Trainer(LSTMHead(F, C, dropout_rate=0.0), device="cpu",
                         **common),
    }
    states = {k: tr.init_state(weights) for k, tr in trainers.items()}
    tb = to_device(batch, "cpu")
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    for _ in range(3):
        jstate, jm = jtr.train_step(jstate, jb, jax.random.PRNGKey(0))
        got = {}
        for k, tr in trainers.items():
            states[k], m = tr.train_step(states[k], tb, tr.generator)
            got[k] = float(m["loss"])
        np.testing.assert_allclose(got["seq"], got["plain"],
                                   **TRAIN_LOSS_TOL)
        np.testing.assert_allclose(got["seq"], float(jm["loss"]),
                                   **TRAIN_LOSS_TOL)
    ev = {k: float(tr.eval_step(states[k], tb)["loss"])
          for k, tr in trainers.items()}
    np.testing.assert_allclose(ev["seq"], ev["plain"], **TRAIN_LOSS_TOL)
    np.testing.assert_allclose(ev["seq"], float(jtr.eval_step(jstate, jb)[
        "loss"]), **TRAIN_LOSS_TOL)


def test_seq_trainer_refuses_a_non_lattice_loss():
    from ctc_tpu_torch.models import LSTMHead
    from ctc_tpu_torch.train.trainer import Trainer

    with pytest.raises(ValueError, match="lattice loss"):
        Trainer(LSTMHead(8, 5), loss_kind="ce", seq_parallel=4, device="cpu")


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

CLI = ["--dataset", "synthetic", "--extract-feat-dim", "16",
       "--batch-size", "8", "--temporal", "8", "--device", "cpu"]
SEQ_CLI = CLI + ["--seq-parallel", "4"]


def _rows(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


def test_cli_seq_parallel_trains_and_decodes_as_unsharded(tmp_path):
    """A --seq-parallel 4 blank run learns; --evaluate --decode with and
    without --seq-parallel writes the same rows from its checkpoint."""
    cache = str(tmp_path / "run")
    blank = ["--loss", "blank", "--c-class", "9", "--lr", "1e-2",
             "--cache-dir", cache]
    seq = ["--seq-parallel", "4", "--seq-microbatches", "8"]
    history = main(CLI + blank + seq + ["--epochs", "3"])
    losses = [h["train"]["loss"] for h in history]
    assert np.all(np.isfinite(losses)) and losses[-1] < losses[0]
    resume = ["--evaluate", "--decode", "--resume", str(tmp_path / "run" /
                                                        "test")]
    sharded = main(CLI + blank + seq + resume)
    rows = _rows(sharded["decoded_csv"])
    unsharded = main(CLI + blank + resume)
    assert len(rows) - 1 == 2 * 8
    assert rows == _rows(unsharded["decoded_csv"])
    np.testing.assert_allclose(sharded["loss"], unsharded["loss"], **TOL)


@pytest.mark.parametrize(
    "flags,match",
    [(["--temporal", "6"], "divisible by --seq-parallel"),
     (["--batch-size", "6"], "microbatch count"),
     (["--loss", "blank", "--evaluate", "--decode", "--decode-beam", "4"],
      "does not compose with --seq-parallel")],
    ids=["T-not-divisible", "batch-not-divisible", "beam"],
)
def test_cli_seq_refusals(tmp_path, flags, match):
    with pytest.raises(SystemExit, match=match):
        main(SEQ_CLI + ["--cache-dir", str(tmp_path)] + flags)
    # nothing ran: not even the log tee
    assert not (tmp_path / "test" / "log.txt").exists()


def test_decode_windows_seq_mesh_matches_unsharded():
    from ctc_tpu_torch.data import synthetic_feature_batches
    from ctc_tpu_torch.models import LSTMHead

    batches = synthetic_feature_batches(num_batches=2, batch_size=4,
                                        temporal=8, feat_dim=16,
                                        num_classes=9, seed=5)
    model = LSTMHead(16, 9, dropout_rate=0.0)
    model.reset_parameters(torch.Generator().manual_seed(1))
    for blank in (0, -1):
        got = tvideo.decode_windows(model, batches, blank=blank,
                                    seq_mesh=make_seq_mesh(N_SHARDS, "cpu"))
        want = tvideo.decode_windows(model, batches, blank=blank)
        np.testing.assert_array_equal(got["decoded"], want["decoded"])
        np.testing.assert_array_equal(got["lengths"], want["lengths"])


# ---------------------------------------------------------------------------
# on the card: the four boundary kernels against their plain versions
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _card_vjp(op, dev, em, r0, r1, extra, d_final, d_boundary):
    e, a, b = (torch.tensor(x).to(dev).requires_grad_() for x in (em, r0, r1))
    final, boundary = op(e, a, b, *[x.to(dev) for x in extra])
    ((final * torch.tensor(d_final).to(dev)).sum()
     + (boundary * torch.tensor(d_boundary).to(dev)).sum()).backward()
    torch.cuda.synchronize()
    return [x.detach().cpu().numpy() for x in (final, boundary, e.grad,
                                               a.grad, b.grad)]


# the card cases beyond SHARD_CASES: the main-path shard, and the shard
# backward's edges (T not a multiple of its 16-row alpha chunk, T below it,
# the width where its plan drops to 4-row chunks, W = 1)
CARD_SHARD_CASES = {
    "main_path": (16, 32, 64, "random", list(range(-2, 30))),
    "T37": (37, 8, 24, "random", [37, 0, 1, 20, 36, 38, 50, -2]),
    "T3": (3, 8, 10, "random", [3, 0, 1, 2, 4, 6, -1, 3]),
    "plan_boundary": (5, 3, 819, "random", [5, 2, 7]),
    "W1": (5, 4, 1, "init", [1, 5, 9, 0]),
    # the shard forward: one warp and two (the first halo exchange at step
    # 8), and the widest row of its warps layout and the narrowest of its
    # block layout
    "one_warp": (20, 4, 32, "random", [20, 2, 7, 0]),
    "two_warps": (20, 4, 33, "random", [20, 2, 7, 0]),
    "warps_widest": (6, 4, 768, "random", [6, 2, 7, 0]),
    "block_narrowest": (6, 4, 769, "random", [6, 2, 7, 0]),
}
BLANK_CARD_SHARD_CASES = {
    "main_path": (16, 64, 32, "random", list(range(-2, 62))),
    "T37": (37, 8, 12, "random", [37, 0, 1, 20, 36, 38, 50, -2]),
    "T3": (3, 8, 4, "random", [3, 0, 1, 2, 4, 6, -1, 3]),
    "plan_boundary": (5, 3, 329, "random", [5, 2, 7]),  # S = 659
    "W1": (5, 4, 0, "random", [1, 5, 9, 0]),  # S = 1: the blank slot alone
    "one_warp": (20, 4, 15, "random", [20, 2, 7, 0]),  # S = 31
    "two_warps": (20, 4, 16, "random", [20, 2, 7, 0]),  # S = 33
    "warps_widest": (6, 4, 255, "random", [6, 2, 7, 0]),  # S = 511
    "block_narrowest": (6, 4, 256, "random", [6, 2, 7, 0]),  # S = 513
}


def _refuse(*args):
    raise AssertionError("a torch-op epilogue (init_row_grads or "
                         "gather_final) ran on the kernel path")


def _check_forward_triples(module, family, dev, em, extra, r0, r1,
                           monkeypatch):
    """The shard forward kernel's ``(alpha, final, boundary)``, one launch
    each, on em as given and on em as the second of three batch slices of
    a wider batch (read in place, strided in B), with ``gather_final``
    refused; both against the plain version's on em."""
    rng = np.random.default_rng(11)
    noise = [rng.standard_normal(em.shape).astype(np.float32)
             for _ in range(2)]
    wide = torch.tensor(np.concatenate([noise[0], em, noise[1]], axis=1))
    batch = em.shape[1]
    em_slice = wide.to(dev)[:, batch:2 * batch]
    assert em_slice.stride(0) == 3 * batch * em_slice.stride(1)
    em_dev = torch.tensor(em).to(dev)
    # the kernel's operand types: int32 lengths, the uint8 skip mask
    args = [x.to(dev) if x.dtype == torch.uint8 else x.to(dev, torch.int32)
            for x in extra]
    rows = [torch.tensor(x).to(dev) for x in (r0, r1)]
    kernel = getattr(module, f"{family}_shard_forward_kernel")
    before = module.launch_counts[f"{family}_shard_forward"]
    with monkeypatch.context() as m:
        m.setattr(module, "gather_final", _refuse)
        got = [kernel(e, *args, *rows) for e in (em_dev, em_slice)]
    assert module.launch_counts[f"{family}_shard_forward"] - before == 2
    want = getattr(module, f"{family}_shard_forward_plain")(em_dev, *args,
                                                            *rows)
    for label, triple in zip(("contiguous", "batch slice"), got):
        for name, g, w in zip(("alpha", "final", "boundary"), triple, want):
            np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(),
                                       err_msg=f"{label} {name}", **LOSS_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(SHARD_CASES) + list(CARD_SHARD_CASES))
def test_noblank_shard_kernels_match_plain_on_card(cuda_device, case,
                                                   monkeypatch):
    T, B, L, rows, lengths = {**SHARD_CASES, **CARD_SHARD_CASES}[case]
    em, r0, r1, inl, d_final, d_boundary = _shard_case(
        9, T, B, L, rows, lengths, lc.noblank_alpha_init)
    tgt = np.random.default_rng(2).integers(1, L + 1, size=B).astype(np.int32)
    extra = (torch.tensor(inl), torch.tensor(tgt))
    before = dict(lc.launch_counts)
    with monkeypatch.context() as m:
        # the kernels compute the final cell, the boundary row and the init
        # rows' gradients themselves
        m.setattr(lc, "init_row_grads", _refuse)
        m.setattr(lc, "gather_final", _refuse)
        got = _card_vjp(lc.noblank_shard_lattice_cuda, cuda_device, em, r0,
                        r1, extra, d_final, d_boundary)
    assert (lc.launch_counts["noblank_shard_forward"]
            - before["noblank_shard_forward"]) == 1
    assert (lc.launch_counts["noblank_shard_backward"]
            - before["noblank_shard_backward"]) == 1
    want = _card_vjp(lc.noblank_shard_lattice_plain, cuda_device, em, r0, r1,
                     extra, d_final, d_boundary)
    for name, g, w in zip(("final", "boundary", "d em", "d stay0", "d adv0"),
                          got, want):
        np.testing.assert_allclose(
            g, w, err_msg=name,
            **(LOSS_TOL if name in ("final", "boundary") else GRAD_TOL))
    _check_forward_triples(lc, "noblank", cuda_device, em, extra, r0, r1,
                           monkeypatch)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(BLANK_SHARD_CASES)
                         + list(BLANK_CARD_SHARD_CASES))
def test_blank_shard_kernels_match_plain_on_card(cuda_device, case,
                                                 monkeypatch):
    T, B, L, rows, lengths = {**BLANK_SHARD_CASES,
                              **BLANK_CARD_SHARD_CASES}[case]
    if L:
        targets, tgt = _blank_targets(3, B, L, case.startswith("repeats"))
        logits = torch.tensor(np.random.default_rng(4).standard_normal(
            (T, B, 7)).astype(np.float32))
        _, skip = blank_emissions_and_skip(logits, torch.tensor(targets), 0)
    else:  # no labels: nothing skips into the one slot
        tgt = np.zeros(B, np.int32)
        skip = torch.zeros((B, 1), dtype=torch.bool)
    em, r0, r1, inl, d_final, d_boundary = _shard_case(
        5, T, B, 2 * L + 1, rows, lengths, bl.blank_alpha_init)
    extra = (skip, torch.tensor(inl), torch.tensor(tgt))
    before = dict(bl.launch_counts)
    with monkeypatch.context() as m:
        # the kernels compute the final cells, the boundary row and the
        # init rows' gradients themselves
        m.setattr(bl, "init_row_grads", _refuse)
        m.setattr(bl, "gather_final", _refuse)
        got = _card_vjp(bl.blank_shard_lattice_cuda, cuda_device, em, r0, r1,
                        extra, d_final, d_boundary)
    assert (bl.launch_counts["blank_shard_forward"]
            - before["blank_shard_forward"]) == 1
    assert (bl.launch_counts["blank_shard_backward"]
            - before["blank_shard_backward"]) == 1
    want = _card_vjp(bl.blank_shard_lattice_plain, cuda_device, em, r0, r1,
                     extra, d_final, d_boundary)
    for name, g, w in zip(("final", "boundary", "d em", "d init0",
                           "d skip0"), got, want):
        np.testing.assert_allclose(
            g, w, err_msg=name,
            **(LOSS_TOL if name in ("final", "boundary") else GRAD_TOL))
    _check_forward_triples(bl, "blank", cuda_device, em,
                           (skip.to(torch.uint8),) + extra[1:], r0, r1,
                           monkeypatch)
