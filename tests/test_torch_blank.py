"""ctc_tpu_torch's blank CTC (loss, lattice op, CUDA kernels) against
ctc_tpu's (the XLA scan and the Pallas kernel in interpret mode) and
``torch.nn.CTCLoss``, on the CPU; and the CUDA kernels against the plain
version on the card.

JAX is imported inside the helpers, not at the top: the card's machine has
no JAX, and the ``cuda`` tests below run there on their own
(``python -m pytest tests/test_torch_blank.py -m cuda``).

Tolerances are the JAX suite's own for its blank Pallas kernel against the
XLA scan (tests/test_blank_pallas.py:51-52): loss rtol/atol 1e-5 (f32
log-space sums in another order), gradient rtol 2e-3 / atol 2e-5 (the
occupancy recursion multiplies T softmax weights, so rounding compounds
with T).
"""

import numpy as np
import pytest
import torch

from ctc_tpu_torch import losses as tlosses
from ctc_tpu_torch.losses import blank as tblank
from ctc_tpu_torch.ops import blank_lattice_cuda as bl
from ctc_tpu_torch.ops import dispatch

LOSS_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=2e-3, atol=2e-5)


def _labels(rng, B, L, C, repeats=False, with_blank=False):
    targets = rng.integers(1, C, size=(B, L)).astype(np.int32)
    if repeats:
        targets[:, 1::2] = targets[:, ::2][:, : targets[:, 1::2].shape[1]]
    if with_blank:
        targets[:, 1] = 0  # a label equal to the blank id
        targets[0, 3] = 0
    return targets


def _case(rng, name):
    """``(logits [T, B, C], targets [B, L], input_lengths, target_lengths,
    cotangent [B])`` for one named case."""
    if name == "small":
        T, B, C, L = 16, 4, 8, 5
        targets = _labels(rng, B, L, C)
    elif name == "repeats":
        T, B, C, L = 24, 5, 10, 6
        targets = _labels(rng, B, L, C, repeats=True)
    elif name == "odd-sizes":
        T, B, C, L = 37, 5, 11, 9
        targets = _labels(rng, B, L, C, repeats=True)
    elif name == "label-blank":
        T, B, C, L = 20, 4, 6, 4
        targets = _labels(rng, B, L, C, with_blank=True)
    else:
        T, B, C, L = 16, 5, 8, 5
        targets = _labels(rng, B, L, C, repeats=True)
    logits = (2.0 * rng.standard_normal((T, B, C))).astype(np.float32)
    in_len = rng.integers(2 * L + 1, T + 1, size=B)
    tgt_len = rng.integers(1, L + 1, size=B)
    in_len[0], tgt_len[0] = T, L
    if name == "zero-length":
        tgt_len[[1, 3]] = 0
        in_len[3] = 3
    elif name == "short-inputs":
        # one label fits one frame; two distinct labels fit two frames
        targets[:, 1] = np.where(targets[:, 1] == targets[:, 0],
                                 targets[:, 0] % (C - 1) + 1, targets[:, 1])
        in_len[:], tgt_len[:] = [1, 2, 2, 1, 2], [1, 2, 1, 0, 0]
    elif name == "infeasible":
        in_len[1], tgt_len[1] = 4, 5  # 5 labels cannot fit 4 frames
    elif name == "input-length-0":
        in_len[2] = 0
    cot = rng.standard_normal(logits.shape[1]).astype(np.float32)
    return logits, targets, in_len, tgt_len, cot


def _port_value_and_grad(logits, targets, in_len, tgt_len, cot, reduction,
                         **kw):
    x = torch.tensor(logits, requires_grad=True)
    out = tblank.ctc_loss(x, torch.tensor(targets), torch.tensor(in_len),
                          torch.tensor(tgt_len), reduction=reduction, **kw)
    v = out if reduction != "none" else (out * torch.tensor(cot)).sum()
    v.backward()
    return float(v.detach()), x.grad.numpy()


def _jax_value_and_grad(impl, logits, targets, in_len, tgt_len, cot,
                        reduction):
    import jax
    import jax.numpy as jnp

    from ctc_tpu import losses as jlosses

    args = tuple(map(jnp.asarray, (targets, in_len, tgt_len)))

    def f(x):
        out = jlosses.ctc_loss(x, *args, reduction=reduction,
                               implementation=impl, interpret=True)
        return out if reduction != "none" else jnp.sum(out * cot)

    v, g = jax.value_and_grad(f)(jnp.asarray(logits))
    return float(v), np.asarray(g)


def _torch_ctc_value_and_grad(logits, targets, in_len, tgt_len, cot,
                              reduction):
    x = torch.tensor(logits, requires_grad=True)
    out = torch.nn.CTCLoss(blank=0, reduction=reduction)(
        torch.log_softmax(x, dim=2), torch.tensor(targets),
        torch.tensor(in_len), torch.tensor(tgt_len))
    v = out if reduction != "none" else (out * torch.tensor(cot)).sum()
    v.backward()
    return float(v.detach()), x.grad.numpy()


# (case, reference).  torch.nn.CTCLoss is held only on feasible targets
# without a blank label: it gives inf for an infeasible target, has no
# "input length 0" rule, and lets a skip enter a label equal to the blank.
# The Pallas path reads the clamped row -1 for input length 0 where the XLA
# scan (and the port) give 0.
PAIRS = (
    [(c, r) for c in ("small", "repeats", "odd-sizes", "zero-length",
                      "short-inputs")
     for r in ("xla", "pallas", "torch")]
    + [(c, r) for c in ("label-blank", "infeasible") for r in ("xla",
                                                                "pallas")]
    + [("input-length-0", "xla")]
)


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
@pytest.mark.parametrize("case,ref", PAIRS,
                         ids=[f"{c}-{r}" for c, r in PAIRS])
def test_ctc_loss_matches_references(case, ref, reduction):
    rng = np.random.default_rng(sum(map(ord, case)))
    logits, targets, in_len, tgt_len, cot = _case(rng, case)
    v_t, g_t = _port_value_and_grad(logits, targets, in_len, tgt_len, cot,
                                    reduction)
    if ref == "torch":
        v_r, g_r = _torch_ctc_value_and_grad(logits, targets, in_len,
                                             tgt_len, cot, reduction)
    else:
        v_r, g_r = _jax_value_and_grad(ref, logits, targets, in_len,
                                       tgt_len, cot, reduction)
    np.testing.assert_allclose(v_t, v_r, **LOSS_TOL)
    if case == "infeasible" and ref == "xla":
        # the sample's gradient is the split of a sentinel-scale final cell;
        # the XLA scan subtracts the row logsumexp before the DP, the port
        # (like the Pallas path it follows) after it, and the sentinel
        # absorbs the two differently.  Every other sample is held.
        keep = np.arange(logits.shape[1]) != 1
        g_t, g_r = g_t[:, keep], g_r[:, keep]
    np.testing.assert_allclose(g_t, g_r, **GRAD_TOL)


def test_infeasible_and_empty_input_samples():
    """An infeasible target gives a sentinel-scale loss (not inf); an input
    length of 0 gives loss 0 and no gradient."""
    rng = np.random.default_rng(3)
    logits, targets, in_len, tgt_len, _ = _case(rng, "infeasible")
    in_len[3] = 0
    x = torch.tensor(logits, requires_grad=True)
    nll = tblank.ctc_loss(x, torch.tensor(targets), torch.tensor(in_len),
                          torch.tensor(tgt_len), reduction="none")
    nll.sum().backward()
    nll = nll.detach().numpy()
    assert 1e29 < nll[1] < 1e31
    assert nll[3] == 0.0 and np.all(x.grad.numpy()[:, 3] == 0.0)
    assert np.all(np.isfinite(x.grad.numpy()))
    feasible = np.ones(len(nll), bool)
    feasible[[1, 3]] = False
    assert np.all((nll[feasible] > 0) & (nll[feasible] < 1e3))


def test_emissions_and_skip_match_jax():
    import jax.numpy as jnp

    from ctc_tpu.losses import blank as jblank

    rng = np.random.default_rng(5)
    logits, targets, _, _, _ = _case(rng, "label-blank")
    targets[1, 2:] = -1  # padding wraps modulo C
    for normalize in (False, True):
        em_j, skip_j = jblank.blank_emissions_and_skip(
            jnp.asarray(logits), jnp.asarray(targets), 0, normalize=normalize)
        em_t, skip_t = tblank.blank_emissions_and_skip(
            torch.tensor(logits), torch.tensor(targets), 0,
            normalize=normalize)
        np.testing.assert_allclose(em_t.numpy(), np.asarray(em_j), **LOSS_TOL)
        np.testing.assert_array_equal(skip_t.numpy(), np.asarray(skip_j))
    z = tblank._expand_targets(torch.tensor(targets), 0)
    np.testing.assert_array_equal(
        z.numpy(), np.asarray(jblank._expand_targets(jnp.asarray(targets), 0)))


def test_emission_gather_gradient_is_torch_gathers():
    """The gather's one-hot backward (a fixed summation order) gives
    ``torch.gather``'s gradient: each class gets the sum of its slots'
    cotangents, the blank's L + 1 slots and repeated labels included."""
    rng = np.random.default_rng(23)
    logits, targets, _, _, _ = _case(rng, "repeats")
    cot = torch.tensor(rng.standard_normal(
        (logits.shape[0], targets.shape[0], 2 * targets.shape[1] + 1)
    ).astype(np.float32))
    x = torch.tensor(logits, requires_grad=True)
    em, _ = tblank.blank_emissions_and_skip(x, torch.tensor(targets), 0)
    em.backward(cot)
    y = torch.tensor(logits, requires_grad=True)
    z = tblank._expand_targets(torch.tensor(targets).long(), 0)
    torch.gather(y, 2, z[None].expand(y.shape[0], -1, -1)).backward(cot)
    np.testing.assert_allclose(x.grad.numpy(), y.grad.numpy(), rtol=1e-6,
                               atol=1e-6)


def _lattice_case(rng, T, B, L, C=12):
    """Normalized gathered emissions, the skip mask, lengths and a
    cotangent, from random logits and labels (repeats and a blank label
    included)."""
    logits = rng.standard_normal((T, B, C)).astype(np.float32)
    targets = _labels(rng, B, L, C, repeats=True)
    targets[-1, 0] = 0
    em, skip = tblank.blank_emissions_and_skip(
        torch.tensor(logits), torch.tensor(targets), 0, normalize=True)
    in_len = rng.integers(min(2 * L + 1, T), T + 1, size=B)
    tgt_len = rng.integers(0, L + 1, size=B)
    in_len[0], tgt_len[0] = T, L
    cot = rng.standard_normal(B).astype(np.float32)
    return em.numpy(), skip.numpy(), in_len, tgt_len, cot


@pytest.mark.parametrize("layout", ["tbl", "tlb"])
@pytest.mark.parametrize("T,B,L", [(16, 4, 5), (29, 6, 10), (9, 3, 1)],
                         ids=["small", "odd-sizes", "L1"])
def test_lattice_op_matches_pallas(T, B, L, layout):
    """``blank_lattice_nll_plain`` against ``blank_lattice_nll_pallas`` in
    interpret mode, on the same emissions: per-sample NLL and d/d em."""
    import jax
    import jax.numpy as jnp

    from ctc_tpu.ops.blank_lattice_pallas import blank_lattice_nll_pallas

    rng = np.random.default_rng(T * B + L)
    em, skip, in_len, tgt_len, cot = _lattice_case(rng, T, B, L)
    if layout == "tlb":
        em = np.ascontiguousarray(em.transpose(0, 2, 1))
    args = tuple(map(jnp.asarray, (skip, in_len, tgt_len)))

    def f(e):
        nll = blank_lattice_nll_pallas(e, *args, layout=layout,
                                       interpret=True)
        return jnp.sum(nll * cot), nll

    (_, nll_j), g_j = jax.value_and_grad(f, has_aux=True)(jnp.asarray(em))
    e = torch.tensor(em, requires_grad=True)
    nll_t = bl.blank_lattice_nll_plain(
        e, torch.tensor(skip), torch.tensor(in_len), torch.tensor(tgt_len),
        layout=layout)
    (nll_t * torch.tensor(cot)).sum().backward()
    assert e.grad.shape == em.shape
    np.testing.assert_allclose(nll_t.detach().numpy(), np.asarray(nll_j),
                               **LOSS_TOL)
    np.testing.assert_allclose(e.grad.numpy(), np.asarray(g_j), **GRAD_TOL)


def test_rows_past_input_length_have_zero_gradient():
    rng = np.random.default_rng(11)
    em, skip, in_len, tgt_len, cot = _lattice_case(rng, 20, 6, 4)
    in_len[1:] = [9, 1, 12, 20, 10]
    tgt_len[2] = 0
    e = torch.tensor(em, requires_grad=True)
    nll = bl.blank_lattice_nll_plain(e, torch.tensor(skip),
                                     torch.tensor(in_len),
                                     torch.tensor(tgt_len))
    (nll * torch.tensor(cot)).sum().backward()
    g = e.grad.numpy()
    for b, n in enumerate(in_len):
        assert np.all(g[n:, b] == 0.0), b
        assert np.any(g[:n, b] != 0.0), b
        # slots past 2 L_b never feed the loss
        assert np.all(g[:, b, 2 * tgt_len[b] + 1:] == 0.0), b


def test_cuda_wrapper_on_cpu_tensor_is_the_plain_version():
    rng = np.random.default_rng(13)
    em, skip, in_len, tgt_len, cot = _lattice_case(rng, 16, 4, 5)
    before = dict(bl.launch_counts)
    out = {}
    for name, fn in (("cuda", bl.blank_lattice_nll_cuda),
                     ("plain", bl.blank_lattice_nll_plain)):
        e = torch.tensor(em, requires_grad=True)
        nll = fn(e, torch.tensor(skip), torch.tensor(in_len),
                 torch.tensor(tgt_len))
        (nll * torch.tensor(cot)).sum().backward()
        out[name] = (nll.detach().numpy(), e.grad.numpy())
    np.testing.assert_array_equal(out["cuda"][0], out["plain"][0])
    np.testing.assert_array_equal(out["cuda"][1], out["plain"][1])
    assert bl.launch_counts == before


def test_dispatch_and_operand_checks():
    rng = np.random.default_rng(17)
    em, skip, in_len, tgt_len, _ = _lattice_case(rng, 8, 2, 3)
    em_t, skip_t = torch.tensor(em), torch.tensor(skip)
    lens = (torch.tensor(in_len), torch.tensor(tgt_len))
    with pytest.raises(ValueError, match="CUDA"):
        dispatch.blank_lattice_nll(em_t, skip_t, *lens,
                                   implementation="cuda")
    with pytest.raises(ValueError, match="unknown"):
        dispatch.blank_lattice_nll(em_t, skip_t, *lens,
                                   implementation="pallas")
    with pytest.raises(TypeError, match="float32"):
        bl.blank_lattice_nll_cuda(em_t.double(), skip_t, *lens)
    with pytest.raises(ValueError, match="skip_ok"):
        bl.blank_lattice_nll_cuda(em_t, skip_t[:, :-1], *lens)
    with pytest.raises(ValueError, match="target_lengths"):
        bl.blank_lattice_nll_cuda(em_t, skip_t, lens[0], lens[1][:1])
    # the launchers take CUDA tensors only: no quiet CPU run
    with pytest.raises(ValueError, match="CUDA"):
        bl.blank_alpha_kernel(em_t, skip_t.to(torch.uint8),
                              *(x.to(torch.int32) for x in lens))
    assert tlosses.LOSS_FNS["blank"] is tlosses.ctc_loss


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize(
    "T,B,L",
    [(10, 256, 5), (128, 64, 20), (37, 11, 9), (9, 3, 1), (20, 3, 800)],
    ids=["main-path", "bench-width", "odd-sizes", "L1", "wide-S"],
)
def test_kernels_match_plain_on_card(cuda_device, T, B, L):
    rng = np.random.default_rng(T + B + L)
    em, skip, in_len, tgt_len, cot = _lattice_case(rng, T, B, L)
    in_len[1] = 1
    in_len[2] = 2
    tgt_len[2] = min(tgt_len[2], 1)
    args = [torch.tensor(x).to(cuda_device) for x in (skip, in_len, tgt_len)]
    cot_d = torch.tensor(cot).to(cuda_device)
    out = {}
    for name, fn in (("kernel", bl.blank_lattice_nll_cuda),
                     ("plain", bl.blank_lattice_nll_plain)):
        e = torch.tensor(em).to(cuda_device).requires_grad_()
        before = dict(bl.launch_counts)
        nll = fn(e, *args)
        (nll * cot_d).sum().backward()
        torch.cuda.synchronize()
        launched = {k: bl.launch_counts[k] - before[k] for k in before}
        out[name] = (nll.detach().cpu().numpy(), e.grad.cpu().numpy(),
                     launched)
    assert out["kernel"][2] == {"blank_lattice_forward": 1,
                                "blank_lattice_backward": 1,
                                "blank_shard_forward": 0,
                                "blank_shard_backward": 0}
    assert out["plain"][2] == {"blank_lattice_forward": 0,
                               "blank_lattice_backward": 0,
                               "blank_shard_forward": 0,
                               "blank_shard_backward": 0}
    np.testing.assert_allclose(out["kernel"][0], out["plain"][0], **LOSS_TOL)
    np.testing.assert_allclose(out["kernel"][1], out["plain"][1], **GRAD_TOL)
    g = out["kernel"][1]
    for b, n in enumerate(in_len):
        assert np.all(g[n:, b] == 0.0), b


@pytest.mark.cuda
def test_ctc_loss_on_card_matches_cpu(cuda_device):
    """The whole loss from logits, card (kernels) against CPU (plain)."""
    rng = np.random.default_rng(19)
    logits, targets, in_len, tgt_len, cot = _case(rng, "repeats")
    got = {}
    for dev in ("cpu", cuda_device):
        x = torch.tensor(logits).to(dev).requires_grad_()
        out = tblank.ctc_loss(x, torch.tensor(targets).to(dev),
                              torch.tensor(in_len).to(dev),
                              torch.tensor(tgt_len).to(dev))
        out.backward()
        got[str(dev)] = (float(out.detach()), x.grad.cpu().numpy())
    (v_c, g_c), (v_g, g_g) = got["cpu"], got["cuda"]
    np.testing.assert_allclose(v_g, v_c, **LOSS_TOL)
    np.testing.assert_allclose(g_g, g_c, **GRAD_TOL)


@pytest.mark.cuda
def test_ctc_loss_gradient_repeats_on_card(cuda_device):
    """Two backwards of the loss on the card give the same gradient bit
    for bit (no atomics in the emission gather's backward)."""
    rng = np.random.default_rng(29)
    logits, targets, in_len, tgt_len, _ = _case(rng, "repeats")
    grads = []
    for _ in range(2):
        x = torch.tensor(logits).to(cuda_device).requires_grad_()
        tblank.ctc_loss(x, torch.tensor(targets).to(cuda_device),
                        torch.tensor(in_len).to(cuda_device),
                        torch.tensor(tgt_len).to(cuda_device)).backward()
        grads.append(x.grad.cpu().numpy())
    np.testing.assert_array_equal(grads[0], grads[1])
