"""ctc_tpu_torch's training-health guards against ctc_tpu's on the CPU: a
non-finite update is skipped and counted, the grad-norm guard leaves the
gradient alone and prints the lines ctc_tpu's ``jax.debug.print`` prints,
and ``--profile-dir`` writes a trace (``tests/test_guards.py``).

Tolerances: updates exactly (the same f32 operations on both sides), grad
norms rtol 1e-5 (sums of squares in another order).
"""

import json
import re

import numpy as np
import torch

import jax
import jax.numpy as jnp
import optax

from ctc_tpu.train.guards import log_grad_norms as jax_log_grad_norms
from ctc_tpu.train.guards import skip_nonfinite_updates as jax_skip
from ctc_tpu_torch.train.guards import (
    global_norm,
    grad_norm_line,
    log_grad_norms,
    skip_nonfinite_updates,
)
from torch_trainer_pair import batches, pair


def test_skip_nonfinite_updates():
    """SGD(0.1) behind the guard: a good gradient steps, a NaN one keeps
    the parameters and counts one skip, the next good one steps again."""
    tx = jax_skip(optax.sgd(0.1))
    jparams = {"w": jnp.ones((3,))}
    jstate = tx.init(jparams)
    w = torch.ones(3)
    skipped = torch.zeros((), dtype=torch.int64)
    good = np.ones(3, np.float32)
    bad = np.array([1.0, np.nan, 1.0], np.float32)
    for g, want_skipped in ((good, 0), (bad, 1), (good, 1)):
        updates, jstate = tx.update({"w": jnp.asarray(g)}, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        grad = torch.from_numpy(g)
        finite = skip_nonfinite_updates([grad], [w], [w - 0.1 * grad],
                                        skipped)
        assert bool(finite) == bool(np.isfinite(g).all())
        np.testing.assert_array_equal(w.numpy(), np.asarray(jparams["w"]))
        assert int(skipped) == int(jstate.skipped) == want_skipped


def test_skip_nonfinite_updates_waits_for_its_update():
    """``when`` False (an accumulation mini-step) commits nothing and
    counts no skip, even for a NaN gradient."""
    w, skipped = torch.ones(2), torch.zeros((), dtype=torch.int64)
    for g in (torch.ones(2), torch.tensor([np.nan, 1.0])):
        skip_nonfinite_updates([g], [w], [w - g], skipped,
                               when=torch.tensor(False))
        assert torch.equal(w, torch.ones(2)) and int(skipped) == 0


def test_log_grad_norms_identity():
    """The guard reads the gradient and changes nothing; its norm is
    optax's global norm; it is due when the count is a multiple of
    ``every``."""
    tx = optax.chain(jax_log_grad_norms(every=2), optax.sgd(1.0))
    params = {"w": jnp.ones((2,))}
    updates, _ = tx.update({"w": jnp.full((2,), 3.0)}, tx.init(params),
                           params)
    g = [torch.full((2,), 3.0), torch.tensor([[1.0, -2.0]])]
    norm, due = log_grad_norms(g, torch.tensor(0), 2)
    np.testing.assert_allclose(np.asarray(updates["w"]), -g[0].numpy())
    assert torch.equal(g[0], torch.full((2,), 3.0))
    np.testing.assert_allclose(
        float(norm), float(optax.global_norm([jnp.asarray(t.numpy())
                                              for t in g])), rtol=1e-5)
    assert bool(due) and not bool(log_grad_norms(g, torch.tensor(3), 2)[1])
    assert float(global_norm([torch.zeros(3)])) == 0.0


def _norm_lines(text):
    return [(int(m[1]), float(m[2])) for m in re.finditer(
        r"^step (\d+): global grad norm (\S+)$", text, re.M)]


def test_grad_norm_lines_match_jax_debug_print(capsys):
    """accum_grad=2, grad_norm_freq=2 over 6 batches: ctc_tpu prints at
    every batch whose update count is even (each mini-step, with the sum so
    far); the port prints the same lines, counts equal, norms to 1e-5."""
    bs = batches(6, seed=9)
    (jtr, jstate), (tr, state) = pair(bs[0], accum_grad=2, grad_norm_freq=2,
                                      steps_per_epoch=6)
    capsys.readouterr()
    jtr.train_epoch(jstate, bs, epoch=0)
    jax.effects_barrier()
    want = _norm_lines(capsys.readouterr().out)
    tr.train_epoch(state, bs, epoch=0)
    out = capsys.readouterr().out
    got = _norm_lines(out)
    assert [c for c, _ in want] == [0, 0, 2, 2]
    assert [c for c, _ in got] == [c for c, _ in want]
    np.testing.assert_allclose([n for _, n in got], [n for _, n in want],
                               rtol=1e-5)
    assert grad_norm_line(got[0][0], got[0][1]) in out


def test_profile_dir_collects_trace(tmp_path):
    """--profile-dir: the first trained epoch writes a torch.profiler
    trace (a Chrome-trace JSON) into the directory."""
    from ctc_tpu_torch.cli.main import main

    trace_dir = tmp_path / "trace"
    main([
        "--dataset", "synthetic", "--epochs", "2", "--batch-size", "4",
        "--temporal", "6", "--extract-feat-dim", "8", "--v-class", "7",
        "--cache-dir", str(tmp_path), "--name", "prof",
        "--print-train-freq", "100", "--print-test-freq", "100",
        "--profile-dir", str(trace_dir), "--device", "cpu",
    ])
    found = sorted(trace_dir.glob("*.json"))
    assert len(found) == 1, found
    events = json.loads(found[0].read_text())["traceEvents"]
    assert any(e.get("name", "").startswith("aten::") for e in events)
