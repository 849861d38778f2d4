"""ctc_tpu_torch's ST-graph model and criterion against ctc_tpu's on the
CPU, at D = 32, s / o / v 6 / 7 / 8, rank 4 (hidden 1000, as ctc_tpu
always builds it): the heads through ``stgraph_from_jax``; winsmooth;
gtmat; the mean-field loop with non-default weights and initial messages
(which change nothing, in ctc_tpu too); the criterion's sequences, loss
and gradients with respect to the heads at ``msg_n == T`` and ``msg_n <
T``, plain and ``synchronous``, and with an infeasible target; the whole
slice, features to loss, with the gradient of every parameter; the
message store; on the card, the criterion through the blank lattice
kernels against the CPU.

ctc_tpu's criterion runs its blank lattice as the XLA scan on the CPU (its
default there); the port's runs the plain version on a CPU tensor and the
kernels on a CUDA one.  Dropout parity is not held (flax's RNG cannot be
matched): train mode is checked for a generator's repeatability only.

Tolerances: heads and sequences rtol 1e-5 / atol 1e-6; the loss rtol
1e-5; gradients rtol 2e-3 / atol 2e-5 (the lattice's rule); the message
store exactly (the same numpy code on both sides).  Where a tensor's
largest element exceeds 1, its atol is scaled by that element: the heads
(a pair head sums rank products of two 1000-deep MLPs, which cancel;
measured 3.8e-6 at ``oo``, whose largest element is 3.75) and the whole
slice's parameter gradients (its loss is ~1e4 at init, the gradients up
to ~2e3; measured 5.5e-6 of the largest element, at
``pairs.so_t.a_o.bias``).

JAX is imported inside the fixtures and tests, not at the top: the card's
machine has no JAX, and the ``cuda`` test runs there on its own
(``python -m pytest tests/test_torch_stgraph.py -m cuda``).
"""

import numpy as np
import pytest
import torch

from ctc_tpu_torch.models import stgraph as ts
from ctc_tpu_torch.models.convert import stgraph_from_jax

SEQ_TOL = dict(rtol=1e-5, atol=1e-6)
LOSS_RTOL = 1e-5
GRAD_TOL = dict(rtol=2e-3, atol=2e-5)
T, B, D, L = 6, 4, 32, 3
S, O, V, RANK = 6, 7, 8, 4
SIZES = {"s": S, "o": O, "v": V}
KEYS = ("s", "o", "v") + tuple(name for name, _, _ in ts._PAIRS)


def assert_close_scaled(got, want, rtol, atol, name):
    """``assert_allclose`` with ``atol`` scaled by the largest ``|want|``
    (at least 1)."""
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol * scale,
                               err_msg=name)


def np_tree(tree):
    import jax

    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def jax_model():
    """ctc_tpu's STGraphBase, its initial ``params`` (numpy) and its jitted
    eval apply."""
    import jax

    from ctc_tpu.models.stgraph import STGraphBase

    model = STGraphBase(s_classes=S, o_classes=O, v_classes=V,
                        num_low_rank=RANK)
    feat = np.zeros((T, B, D), np.float32)
    params = jax.jit(model.init)(jax.random.PRNGKey(0), feat)["params"]
    apply = jax.jit(lambda p, x: model.apply({"params": p}, x))
    return model, np_tree(params), apply


def port_model(params):
    model = ts.STGraphBase(D, S, O, V, num_low_rank=RANK)
    model.load_state_dict(stgraph_from_jax(params))
    return model


def features(seed=0):
    return np.random.default_rng(seed).standard_normal(
        (T, B, D)).astype(np.float32)


def random_heads(seed, t=T):
    rng = np.random.default_rng(seed)
    heads = {k: rng.standard_normal((t, B, SIZES[k])).astype(np.float32)
             for k in "sov"}
    for name, left, right in ts._PAIRS:
        heads[name] = 0.3 * rng.standard_normal(
            (t, B, SIZES[left], SIZES[right])).astype(np.float32)
    return heads


def targets(seed):
    """s targets in [1, S), o / v label sequences of L in [1, C), lengths
    in [1, L] (sample 0 at L)."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(1, L + 1, size=B)
    lengths[0] = L
    return (rng.integers(1, S, size=B), rng.integers(1, O, size=(B, L)),
            rng.integers(1, V, size=(B, L)), lengths)


def test_heads_match_jax(jax_model):
    """The port carries ctc_tpu's initial weights whole (every key, every
    shape) and gives the same 15 heads in eval mode."""
    _, params, apply = jax_model
    model = port_model(params)
    assert set(stgraph_from_jax(params)) == set(model.state_dict())
    x = features()
    want = apply(params, x)
    with torch.no_grad():
        got = model(torch.tensor(x))
    assert tuple(got) == KEYS and set(want) == set(KEYS)
    for k in KEYS:
        assert_close_scaled(got[k].numpy(), want[k], name=k, **SEQ_TOL)


def test_init_and_dropout():
    """reset_parameters(generator) is repeatable, with flax's init (zero
    biases, kernels truncated at two lecun std); with ``train`` the same
    generator gives the same heads, which differ from eval mode's."""
    a, b = (ts.STGraphBase(D, S, O, V, num_low_rank=RANK) for _ in "ab")
    for m in (a, b):
        m.reset_parameters(torch.Generator().manual_seed(5))
    for (name, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), name
        if name.endswith("bias"):
            assert not p.any(), name
        else:
            std = (1.0 / p.shape[1]) ** 0.5 / 0.87962566103423978
            assert float(p.detach().abs().max()) <= 2 * std, name
    x = torch.tensor(features(1))
    with torch.no_grad():
        eval_out = a(x)
        runs = [a(x, train=True, generator=torch.Generator().manual_seed(2))
                for _ in range(2)]
    for k in KEYS:
        assert torch.equal(runs[0][k], runs[1][k]), k
    for k in ("s",) + KEYS[3:]:
        assert not torch.equal(runs[0][k], eval_out[k]), k
    for k in ("o", "v"):  # no dropout on the linear unary heads
        assert torch.equal(runs[0][k], eval_out[k]), k


@pytest.mark.parametrize("n,k", [(9, 1), (9, 2), (9, 3), (1, 1)])
def test_winsmooth_matches_jax(n, k):
    import jax.numpy as jnp

    from ctc_tpu.models import stgraph as js

    x = np.random.default_rng(n + k).standard_normal(
        (n, 4, 5)).astype(np.float32)
    np.testing.assert_allclose(ts.winsmooth(torch.tensor(x), k).numpy(),
                               np.asarray(js.winsmooth(jnp.asarray(x), k)),
                               **SEQ_TOL)


@pytest.mark.parametrize("sizes", [(6, 5), (6, 5, 3)])
def test_gtmat_matches_jax(sizes):
    """Labels in range, negative and past the last class (a zero row in
    both); float32."""
    import jax.numpy as jnp

    from ctc_tpu.models import stgraph as js

    target = np.array([0, 4, -1, 5, 7, 2])
    got = ts.gtmat(sizes, torch.tensor(target))
    want = np.asarray(js.gtmat(sizes, jnp.asarray(target)))
    assert got.dtype == torch.float32 and tuple(got.shape) == sizes
    np.testing.assert_array_equal(got.numpy(), want)
    assert not got[2:5].any()


def test_mean_field_messages_match_jax():
    """Non-default weights; initial messages given on both sides change
    nothing."""
    import jax.numpy as jnp

    from ctc_tpu.models import stgraph as js

    heads = random_heads(1)
    msg0 = {f"{k}_msg0": np.full((B, SIZES[k]), 3.0, np.float32)
            for k in "sov"}
    kw = dict(msg_n=T, w_temporal=0.7, w_spatio=1.3)
    want = js.mean_field_messages(
        {k: jnp.asarray(v) for k, v in heads.items()}, **kw,
        **{k: jnp.asarray(v) for k, v in msg0.items()})
    theads = {k: torch.tensor(v) for k, v in heads.items()}
    got = ts.mean_field_messages(
        theads, **kw, **{k: torch.tensor(v) for k, v in msg0.items()})
    plain = ts.mean_field_messages(theads, **kw)
    for g, p, w in zip(got, plain, want):
        assert g.shape == (T, B, g.shape[2])
        assert torch.equal(g, p)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **SEQ_TOL)


def jax_criterion(msg_n, synchronous):
    """ctc_tpu's criterion as a jitted function of the heads: (loss, the
    three sequences), the gradient with respect to every head."""
    import jax

    from ctc_tpu.models.stgraph import STGraphCriterion

    crit = STGraphCriterion(msg_n=msg_n)

    def f(heads, s_t, o_t, v_t, lengths):
        *seqs, loss = crit(heads, s_t, o_t, v_t, lengths,
                           synchronous=synchronous)
        return loss, seqs

    return jax.jit(jax.value_and_grad(f, has_aux=True))


def port_criterion(heads, tgts, msg_n, synchronous, device="cpu"):
    theads = {k: torch.tensor(v, device=device, requires_grad=True)
              for k, v in heads.items()}
    crit = ts.STGraphCriterion(msg_n=msg_n)
    *seqs, loss = crit(theads, *(torch.tensor(t, device=device)
                                 for t in tgts), synchronous=synchronous)
    loss.backward()
    return (float(loss.detach()), [s.detach().cpu() for s in seqs],
            {k: h.grad.cpu() for k, h in theads.items()})


def check_criterion(got, want, skip=np.zeros(B, bool)):
    loss, seqs, grads = got
    (w_loss, w_seqs), w_grads = want
    np.testing.assert_allclose(loss, float(w_loss), rtol=LOSS_RTOL)
    for g, w in zip(seqs, w_seqs):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **SEQ_TOL)
    keep = ~skip
    for k in KEYS:
        np.testing.assert_allclose(grads[k].numpy()[:, keep],
                                   np.asarray(w_grads[k])[:, keep],
                                   err_msg=k, **GRAD_TOL)


# msg_n = T - 1 = 5 frames fit any target of L = 3 (three equal labels
# need 5)
@pytest.mark.parametrize("msg_n", [T, T - 1], ids=["msg_n=T", "msg_n<T"])
@pytest.mark.parametrize("synchronous", [False, True],
                         ids=["plain", "synchronous"])
def test_criterion_matches_jax(msg_n, synchronous):
    heads, tgts = random_heads(2), targets(3)
    want = jax_criterion(msg_n, synchronous)(heads, *tgts)
    got = port_criterion(heads, tgts, msg_n, synchronous)
    assert got[1][0].shape == (msg_n, B, S)
    assert 0.0 < got[0] < 1e3
    check_criterion(got, want)


@pytest.mark.parametrize("lattice", ["xla", "pallas"])
def test_criterion_infeasible_target_matches_jax(lattice, monkeypatch):
    """Sample 1's object sequence (4, 4, 5) needs 4 frames and gets 3 (as
    do the seed's others with a repeat): the loss is at the sentinel's
    scale (~1e30) on both sides, and equal.  Against ctc_tpu's XLA scan
    the infeasible samples' gradients are left out: each is the split of a
    sentinel-scale final cell, which the scan splits otherwise than the
    Pallas kernel that the port follows (``tests/test_torch_blank.py``'s
    rule); against the Pallas kernel (interpret mode) every sample is
    held."""
    import functools

    from ctc_tpu.losses.blank import ctc_loss as jax_ctc_loss
    from ctc_tpu.models import stgraph as js
    from ctc_tpu_torch.losses.blank import min_frames

    if lattice == "pallas":
        monkeypatch.setattr(js, "ctc_loss", functools.partial(
            jax_ctc_loss, implementation="pallas", interpret=True))
    heads, (s_t, o_t, v_t, lengths) = random_heads(4), targets(5)
    o_t[1], lengths[1] = (4, 4, 5), 3
    tgts = (s_t, o_t, v_t, lengths)
    msg_n = 3
    infeasible = np.zeros(B, bool)
    for seq in (o_t, v_t):
        infeasible |= min_frames(torch.tensor(seq),
                                 torch.tensor(lengths)).numpy() > msg_n
    assert infeasible[1] and not infeasible.all()
    want = jax_criterion(msg_n, False)(heads, *tgts)
    got = port_criterion(heads, tgts, msg_n, False)
    assert 1e27 < got[0] < 1e31
    check_criterion(got, want, skip=infeasible if lattice == "xla"
                    else np.zeros(B, bool))


def test_whole_slice_matches_jax(jax_model):
    """Features through STGraphBase and the criterion (msg_n = T): the
    loss and the gradient of every parameter."""
    import jax
    import jax.numpy as jnp

    from ctc_tpu.models.stgraph import STGraphCriterion

    model, params, _ = jax_model
    x, tgts = features(6), targets(7)
    crit = STGraphCriterion(msg_n=T)

    def f(p):
        heads = model.apply({"params": p}, jnp.asarray(x))
        return crit(heads, *map(jnp.asarray, tgts))[3]

    w_loss, w_grads = jax.jit(jax.value_and_grad(f))(params)
    port = port_model(params)
    *_, loss = ts.STGraphCriterion(msg_n=T)(
        port(torch.tensor(x)), *map(torch.tensor, tgts))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(w_loss),
                               rtol=LOSS_RTOL)
    want = stgraph_from_jax(np_tree(w_grads))
    named = dict(port.named_parameters())
    assert set(want) == set(named)
    for name, w in want.items():
        assert_close_scaled(named[name].grad.numpy(), w.numpy(), name=name,
                            **GRAD_TOL)


def test_message_store_matches_jax():
    """The same set / get sequence on both stores: past and future
    queries, decay 0.8, eviction at maxsize, an unknown id."""
    from ctc_tpu.models.stgraph import MessageStore as JaxStore

    rng = np.random.default_rng(8)
    stores = [ts.MessageStore(maxsize=3, decay=0.8, sigma=5.0),
              JaxStore(maxsize=3, decay=0.8, sigma=5.0)]
    queries = []
    for step in range(5):
        ids = ["a", "b", "a"]
        times = [float(2 * step), float(step), float(2 * step + 1)]
        msgs = rng.standard_normal((3, 4)).astype(np.float32)
        for store in stores:
            store.set(ids, times, msgs)
        queries.append((["a", "b", "c"], [5.5, 2.0, 1.0]))
    assert [len(q) for q in stores[0]._store.values()] == [3, 3]
    for ids, times in queries:
        for direction in ("past", "future"):
            got, want = (s.get(ids, times, 4, direction) for s in stores)
            np.testing.assert_array_equal(got, want)
    assert not stores[0].get(["c"], [1.0], 4).any()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_criterion_on_card_matches_cpu(cuda_device):
    """The criterion on CUDA heads launches the blank lattice kernels
    three times forward and three times backward; its sequences, loss and
    gradients equal the CPU's."""
    from ctc_tpu_torch.ops import blank_lattice_cuda as bl

    heads, tgts = random_heads(2), targets(3)
    bl.reset_launch_counts()
    got = port_criterion(heads, tgts, T, True, cuda_device)
    torch.cuda.synchronize()
    assert bl.launch_counts["blank_lattice_forward"] == 3
    assert bl.launch_counts["blank_lattice_backward"] == 3
    assert not bl.launch_counts["blank_shard_forward"]
    loss, seqs, grads = port_criterion(heads, tgts, T, True)
    check_criterion(got, ((loss, seqs), grads))
