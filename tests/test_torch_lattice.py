"""ctc_tpu_torch's lattice DP against ctc_tpu's (XLA scan and the Pallas
kernel in interpret mode), and the CUDA kernels against the plain version.

JAX is imported inside the helpers, not at the top: the card's machine has
no JAX, and the ``cuda`` test below runs there on its own
(``python -m pytest tests/test_torch_lattice.py -m cuda``).

Tolerances are the JAX suite's own for its Pallas kernel against the XLA
scan (tests/test_pallas_lattice.py): loss rtol/atol 1e-5 (f32 log-space
sums in another order), gradient rtol 2e-3 / atol 2e-5 (the posterior
recursion multiplies T sigmoid weights, so rounding compounds with T).
"""

import numpy as np
import pytest
import torch

from ctc_tpu_torch.ops import dispatch
from ctc_tpu_torch.ops import lattice_cuda as lc

LOSS_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=2e-3, atol=2e-5)


def _case(rng, T, B, L, degenerate=False):
    em = (rng.standard_normal((T, B, L)) - 1.0).astype(np.float32)
    in_len = rng.integers(1, T + 1, size=B)
    tgt_len = rng.integers(1, L + 1, size=B)
    in_len[0], tgt_len[0] = T, L
    if degenerate:
        in_len[1] = 3  # target_length may exceed input_length
    else:
        tgt_len = np.minimum(tgt_len, in_len)
    cot = rng.standard_normal(B).astype(np.float32)
    return em, in_len, tgt_len, cot


def _jax_value_and_grad(ref, em, in_len, tgt_len, cot, layout="tbl"):
    import jax
    import jax.numpy as jnp

    from ctc_tpu.ops import lattice_xla
    from ctc_tpu.ops.lattice_pallas import noblank_lattice_nll_pallas

    inl, tgt, c = map(jnp.asarray, (in_len, tgt_len, cot))
    if ref == "xla":
        def f(e):
            if layout == "tlb":
                e = jnp.transpose(e, (0, 2, 1))
            return jnp.sum(lattice_xla.noblank_lattice_nll(e, inl, tgt) * c)
    else:
        def f(e):
            return jnp.sum(noblank_lattice_nll_pallas(
                e, inl, tgt, layout=layout, interpret=True) * c)
    v, g = jax.value_and_grad(f)(jnp.asarray(em))
    return float(v), np.asarray(g)


def _torch_value_and_grad(fn, em, in_len, tgt_len, cot, **kw):
    e = torch.tensor(em, requires_grad=True)
    nll = fn(e, torch.tensor(in_len), torch.tensor(tgt_len), **kw)
    v = (nll * torch.tensor(cot)).sum()
    v.backward()
    return float(v.detach()), e.grad.numpy(), nll.detach().numpy()


@pytest.mark.parametrize("ref", ["xla", "pallas"])
@pytest.mark.parametrize(
    "T,B,L,degenerate",
    [(16, 4, 10, False), (128, 8, 32, False), (37, 11, 157, False),
     (24, 4, 12, True), (9, 3, 1, False)],
    ids=["small", "baseline", "odd-sizes", "degenerate", "L1"],
)
def test_plain_matches_jax(rng, ref, T, B, L, degenerate):
    em, in_len, tgt_len, cot = _case(rng, T, B, L, degenerate)
    v_j, g_j = _jax_value_and_grad(ref, em, in_len, tgt_len, cot)
    v_t, g_t, _ = _torch_value_and_grad(lc.noblank_lattice_nll_plain, em,
                                        in_len, tgt_len, cot)
    np.testing.assert_allclose(v_t, v_j, **LOSS_TOL)
    np.testing.assert_allclose(g_t, g_j, **GRAD_TOL)


def test_per_sample_nll_matches_xla(rng):
    import jax.numpy as jnp

    from ctc_tpu.ops import lattice_xla

    em, in_len, tgt_len, _ = _case(rng, 24, 6, 12, degenerate=True)
    want = lattice_xla.noblank_lattice_nll(
        jnp.asarray(em), jnp.asarray(in_len), jnp.asarray(tgt_len))
    got = lc.noblank_lattice_nll_plain(
        torch.tensor(em), torch.tensor(in_len), torch.tensor(tgt_len))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOSS_TOL)


@pytest.mark.parametrize("ref", ["xla", "pallas"])
def test_tlb_layout_matches_jax(rng, ref):
    """``layout='tlb'`` takes ``[T, L, B]`` (what the JAX functions take)
    and returns the gradient in that layout."""
    em, in_len, tgt_len, cot = _case(rng, 28, 5, 21)
    em_tlb = np.ascontiguousarray(em.transpose(0, 2, 1))
    v_j, g_j = _jax_value_and_grad(ref, em_tlb, in_len, tgt_len, cot,
                                   layout="tlb")
    v_t, g_t, _ = _torch_value_and_grad(
        lambda e, i, t: dispatch.lattice_nll(e, i, t, layout="tlb"),
        em_tlb, in_len, tgt_len, cot)
    assert g_t.shape == em_tlb.shape
    np.testing.assert_allclose(v_t, v_j, **LOSS_TOL)
    np.testing.assert_allclose(g_t, g_j, **GRAD_TOL)


def test_rows_past_input_length_have_zero_gradient(rng):
    em, in_len, tgt_len, cot = _case(rng, 20, 6, 8)
    in_len[1:] = [5, 1, 12, 20, 9]
    tgt_len = np.minimum(tgt_len, in_len)
    _, g, _ = _torch_value_and_grad(lc.noblank_lattice_nll_plain, em,
                                    in_len, tgt_len, cot)
    for b, n in enumerate(in_len):
        assert np.all(g[n:, b] == 0.0), b
        assert np.any(g[:n, b] != 0.0), b


def test_cuda_wrapper_on_cpu_tensor_is_the_plain_version(rng):
    em, in_len, tgt_len, cot = _case(rng, 16, 4, 10)
    before = dict(lc.launch_counts)
    v_c, g_c, _ = _torch_value_and_grad(lc.noblank_lattice_nll_cuda, em,
                                        in_len, tgt_len, cot)
    v_p, g_p, _ = _torch_value_and_grad(lc.noblank_lattice_nll_plain, em,
                                        in_len, tgt_len, cot)
    assert v_c == v_p
    np.testing.assert_array_equal(g_c, g_p)
    assert lc.launch_counts == before


def test_dispatch_cuda_on_cpu_tensor_raises(rng):
    em, in_len, tgt_len, _ = _case(rng, 8, 2, 4)
    with pytest.raises(ValueError, match="CUDA"):
        dispatch.lattice_nll(torch.tensor(em), torch.tensor(in_len),
                             torch.tensor(tgt_len), implementation="cuda")
    with pytest.raises(ValueError, match="unknown"):
        dispatch.lattice_nll(torch.tensor(em), torch.tensor(in_len),
                             torch.tensor(tgt_len), implementation="xla")
    assert dispatch.preferred_layout(None) == "tbl"


def test_wrapper_validates_operands(rng):
    em, in_len, tgt_len, _ = _case(rng, 8, 2, 4)
    with pytest.raises(TypeError, match="float32"):
        lc.noblank_lattice_nll_cuda(torch.tensor(em).double(),
                                    torch.tensor(in_len),
                                    torch.tensor(tgt_len))
    with pytest.raises(ValueError, match="target_lengths"):
        lc.noblank_lattice_nll_cuda(torch.tensor(em), torch.tensor(in_len),
                                    torch.tensor(tgt_len[:1]))
    # the launchers take CUDA tensors only: no quiet CPU run
    with pytest.raises(ValueError, match="CUDA"):
        lc.noblank_alpha_kernel(torch.tensor(em),
                                torch.tensor(in_len, dtype=torch.int32),
                                torch.tensor(tgt_len, dtype=torch.int32))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize(
    "T,B,L,degenerate",
    [(10, 256, 10, False), (128, 64, 157, False), (37, 11, 157, False),
     (24, 4, 12, True), (9, 3, 1, False), (20, 3, 1500, False)],
    ids=["main-path", "bench-width", "odd-sizes", "degenerate", "L1",
         "wide-L"],
)
def test_kernels_match_plain_on_card(rng, cuda_device, T, B, L, degenerate):
    em, in_len, tgt_len, cot = _case(rng, T, B, L, degenerate)
    args = [torch.tensor(x).to(cuda_device) for x in (in_len, tgt_len)]
    cot_d = torch.tensor(cot).to(cuda_device)
    out = {}
    for name, fn in (("kernel", lc.noblank_lattice_nll_cuda),
                     ("plain", lc.noblank_lattice_nll_plain)):
        e = torch.tensor(em).to(cuda_device).requires_grad_()
        before = dict(lc.launch_counts)
        nll = fn(e, *args)
        (nll * cot_d).sum().backward()
        torch.cuda.synchronize()
        launched = {k: lc.launch_counts[k] - before[k] for k in before}
        out[name] = (nll.detach().cpu().numpy(), e.grad.cpu().numpy(),
                     launched)
    assert out["kernel"][2] == {"noblank_lattice_forward": 1,
                                "noblank_lattice_backward": 1,
                                "noblank_shard_forward": 0,
                                "noblank_shard_backward": 0}
    assert out["plain"][2] == {"noblank_lattice_forward": 0,
                               "noblank_lattice_backward": 0,
                               "noblank_shard_forward": 0,
                               "noblank_shard_backward": 0}
    np.testing.assert_allclose(out["kernel"][0], out["plain"][0], **LOSS_TOL)
    np.testing.assert_allclose(out["kernel"][1], out["plain"][1], **GRAD_TOL)
    g = out["kernel"][1]
    for b, n in enumerate(in_len):
        assert np.all(g[n:, b] == 0.0), b
