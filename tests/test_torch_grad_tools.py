"""ctc_tpu_torch's gradient tools against ctc_tpu's on the CPU, through
``jax.vjp`` on the same seeded numpy inputs and cotangents: balance_labels
after two update_balance batches (one class without positives, one without
negatives), equalize_grad_norm over three inputs (one with a zero
cotangent) and over one, verbose_gradients' printed norms and its returns,
block_gradient; on the card, each against the CPU.

Tolerances: the gradients rtol 2e-3 / atol 2e-5 (the lattice's rule; these
are a product or a norm ratio, f32 on both sides), the printed norms rtol
1e-5, the counts exactly.

JAX is imported inside the tests, not at the top: the card's machine has
no JAX, and the ``cuda`` test runs there on its own
(``python -m pytest tests/test_torch_grad_tools.py -m cuda``).
"""

import re

import numpy as np
import pytest
import torch

from ctc_tpu_torch.ops import grad_tools as tg

GRAD_TOL = dict(rtol=2e-3, atol=2e-5)
NORM_RTOL = 1e-5
B, C = 6, 5
NORM_LINE = re.compile(r"verbose_gradients: input (\d+) grad norm (\S+)")


def balance_case(seed=0):
    """Two multi-hot target batches (class 0 never positive, class 1 never
    negative), an input and a cotangent."""
    rng = np.random.default_rng(seed)
    batches = [(rng.random((B, C)) < 0.4).astype(np.float32)
               for _ in range(2)]
    for t in batches:
        t[:, 0], t[:, 1] = 0.0, 1.0
    x = rng.standard_normal((B, C)).astype(np.float32)
    cot = rng.standard_normal((B, C)).astype(np.float32)
    return batches, x, cot


def port_balance(batches, x, cot, device):
    state = tg.BalanceState.create(C, device=device)
    for t in batches:
        state = tg.update_balance(state, torch.tensor(t, device=device))
    tx = torch.tensor(x, device=device, requires_grad=True)
    targets = torch.tensor(batches[-1], device=device, requires_grad=True)
    out = tg.balance_labels(tx, targets, state)
    out.backward(torch.tensor(cot, device=device))
    assert out is not tx and torch.equal(out.detach(), tx.detach())
    assert targets.grad is None
    return state, tx.grad


def test_balance_labels_matches_jax():
    import jax
    import jax.numpy as jnp

    from ctc_tpu.ops import grad_tools as jg

    batches, x, cot = balance_case()
    jstate = jg.BalanceState.create(C)
    for t in batches:
        jstate = jg.update_balance(jstate, jnp.asarray(t))
    _, vjp = jax.vjp(
        lambda a: jg.balance_labels(a, jnp.asarray(batches[-1]), jstate),
        jnp.asarray(x))
    want = np.asarray(vjp(jnp.asarray(cot))[0])
    state, got = port_balance(batches, x, cot, "cpu")
    assert state.pos.dtype == state.neg.dtype == torch.float32
    np.testing.assert_array_equal(state.pos.numpy(), np.asarray(jstate.pos))
    np.testing.assert_array_equal(state.neg.numpy(), np.asarray(jstate.neg))
    assert state.pos[0] == 0 and state.neg[1] == 0
    np.testing.assert_allclose(got.numpy(), want, **GRAD_TOL)


def equalize_case(n, seed=1):
    """``n`` inputs of different shapes and cotangents; with three, the
    last cotangent is zero."""
    rng = np.random.default_rng(seed)
    shapes = [(4,), (3, 2), (5,)][:n]
    xs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    cots = [rng.standard_normal(s).astype(np.float32) * 10.0 ** i
            for i, s in enumerate(shapes)]
    if n == 3:
        cots[2] = np.zeros_like(cots[2])
    return xs, cots


def port_equalize(xs, cots, device):
    txs = [torch.tensor(x, device=device, requires_grad=True) for x in xs]
    outs = tg.equalize_grad_norm(*txs)
    assert isinstance(outs, tuple) and len(outs) == len(xs)
    torch.autograd.backward(outs, [torch.tensor(c, device=device)
                                   for c in cots])
    return [t.grad for t in txs]


@pytest.mark.parametrize("n", [1, 3])
def test_equalize_grad_norm_matches_jax(n):
    import jax
    import jax.numpy as jnp

    from ctc_tpu.ops import grad_tools as jg

    xs, cots = equalize_case(n)
    outs, vjp = jax.vjp(jg.equalize_grad_norm, *map(jnp.asarray, xs))
    assert isinstance(outs, tuple) and len(outs) == n
    want = vjp(tuple(map(jnp.asarray, cots)))
    got = port_equalize(xs, cots, "cpu")
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **GRAD_TOL)
    ref = np.linalg.norm(cots[0])
    np.testing.assert_allclose(np.linalg.norm(got[-1 if n == 1 else 1]),
                               ref, rtol=NORM_RTOL)
    if n == 3:
        assert not got[2].any()


def printed_norms(text):
    return [(int(i), float(v)) for i, v in NORM_LINE.findall(text)]


@pytest.mark.parametrize("n", [1, 3])
def test_verbose_gradients_prints_jax_norms(n, capfd):
    import jax
    import jax.numpy as jnp

    from ctc_tpu.ops import grad_tools as jg

    xs, cots = equalize_case(n, seed=2)
    capfd.readouterr()
    _, vjp = jax.vjp(jg.verbose_gradients, *map(jnp.asarray, xs))
    want = vjp(jnp.asarray(cots[0]) if n == 1
               else tuple(map(jnp.asarray, cots)))
    jax.effects_barrier()
    jax_lines = printed_norms(capfd.readouterr().out)

    txs = [torch.tensor(x, requires_grad=True) for x in xs]
    got = tg.verbose_gradients(*txs)
    if n == 1:
        assert isinstance(got, torch.Tensor) and got is not txs[0]
        got = (got,)
    else:
        assert isinstance(got, tuple) and len(got) == n
    torch.autograd.backward(got, [torch.tensor(c) for c in cots])
    port_lines = printed_norms(capfd.readouterr().out)

    assert [i for i, _ in port_lines] == [i for i, _ in jax_lines] == list(
        range(n))
    np.testing.assert_allclose([v for _, v in port_lines],
                               [v for _, v in jax_lines], rtol=NORM_RTOL)
    for t, c, w in zip(txs, cots, want):
        np.testing.assert_array_equal(t.grad.numpy(), c)
        np.testing.assert_array_equal(np.asarray(w), c)


def test_block_gradient_matches_jax():
    import jax
    import jax.numpy as jnp

    from ctc_tpu.ops import grad_tools as jg

    x = np.random.default_rng(3).standard_normal(4).astype(np.float32)
    want = jax.grad(lambda a: jnp.sum(jg.block_gradient(a) * a))(
        jnp.asarray(x))
    tx = torch.tensor(x, requires_grad=True)
    blocked = tg.block_gradient(tx)
    assert not blocked.requires_grad
    (blocked * tx).sum().backward()
    np.testing.assert_array_equal(tx.grad.numpy(), np.asarray(want))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_grad_tools_on_card_match_cpu(cuda_device, capfd):
    """Each op's gradient on the card equals the CPU's; verbose_gradients
    prints the same norms."""
    batches, x, cot = balance_case()
    _, got = port_balance(batches, x, cot, cuda_device)
    _, want = port_balance(batches, x, cot, "cpu")
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), **GRAD_TOL)
    xs, cots = equalize_case(3)
    got = port_equalize(xs, cots, cuda_device)
    for g, w in zip(got, port_equalize(xs, cots, "cpu")):
        np.testing.assert_allclose(g.cpu().numpy(), w.numpy(), **GRAD_TOL)
    lines = {}
    for dev in ("cpu", cuda_device):
        txs = [torch.tensor(x, device=dev, requires_grad=True) for x in xs]
        torch.autograd.backward(tg.verbose_gradients(*txs),
                                [torch.tensor(c, device=dev) for c in cots])
        lines[str(dev)] = printed_norms(capfd.readouterr().out)
    np.testing.assert_allclose([v for _, v in lines["cuda"]],
                               [v for _, v in lines["cpu"]], rtol=NORM_RTOL)
    tx = torch.tensor(xs[0], device=cuda_device, requires_grad=True)
    (tg.block_gradient(tx) * tx).sum().backward()
    np.testing.assert_array_equal(tx.grad.cpu().numpy(), xs[0])
