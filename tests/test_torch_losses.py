"""ctc_tpu_torch's emission functions and losses against ctc_tpu's, on the CPU.

Inputs are made with numpy from a seed and fed to both packages.  Values
agree to f32 rounding (rtol/atol 1e-5: log-softmax, logsumexp and the
class contraction sum in another order); gradients through the lattice use
the JAX suite's kernel tolerance (rtol 2e-3 / atol 2e-5,
tests/test_pallas_lattice.py).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ctc_tpu import losses as jlosses
from ctc_tpu.ops import emissions as jem
from ctc_tpu_torch import losses as tlosses
from ctc_tpu_torch.ops import emissions as tem

VAL_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=2e-3, atol=2e-5)


def _inputs(rng, T=12, B=5, C=9, L=7, binary=False):
    logits = (3.0 * rng.standard_normal((T, B, C))).astype(np.float32)
    in_len = rng.integers(2, T + 1, size=B)
    tgt_len = np.minimum(rng.integers(1, L + 1, size=B), in_len)
    in_len[0], tgt_len[0] = T, L
    if binary:
        paths = (rng.random((B, L, C)) < 0.2).astype(np.float32)
    else:
        paths = rng.integers(0, C, size=(B, L)).astype(np.int32)
        for b in range(B):  # -1 padding past each path's length
            paths[b, tgt_len[b]:] = -1
    return logits, paths, in_len, tgt_len


def test_gather_emissions_match(rng):
    logits, paths, _, _ = _inputs(rng)
    want = np.asarray(jem.gather_log_softmax_emissions(
        jnp.asarray(logits), jnp.asarray(paths)))
    got = tem.gather_log_softmax_emissions(torch.tensor(logits),
                                           torch.tensor(paths))
    np.testing.assert_allclose(got.numpy(), want, **VAL_TOL)
    # tlb: the JAX function pads L to the TPU sublane multiple; the port
    # does not (its kernels read [T, B, L])
    got_tlb = tem.gather_log_softmax_emissions(
        torch.tensor(logits), torch.tensor(paths), layout="tlb")
    np.testing.assert_array_equal(got_tlb.numpy(),
                                  got.numpy().transpose(0, 2, 1))


def test_binary_emissions_match_with_clamp(rng):
    logits, paths, _, _ = _inputs(rng, binary=True)
    logits[0, 0, :3] = [150.0, -150.0, 0.0]  # saturate into the -100 clamp
    want = np.asarray(jem.binary_ce_emissions(jnp.asarray(logits),
                                              jnp.asarray(paths)))
    got = tem.binary_ce_emissions(torch.tensor(logits), torch.tensor(paths))
    np.testing.assert_allclose(got.numpy(), want, **VAL_TOL)
    got_tlb = tem.binary_ce_emissions(torch.tensor(logits),
                                      torch.tensor(paths), layout="tlb")
    np.testing.assert_allclose(got_tlb.numpy(),
                               got.numpy().transpose(0, 2, 1), **VAL_TOL)


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
@pytest.mark.parametrize("kind", ["noblank", "binary"])
def test_lattice_losses_and_logit_grads_match(rng, kind, reduction):
    binary = kind == "binary"
    logits, paths, in_len, tgt_len = _inputs(rng, binary=binary)
    jfn = (jlosses.no_blank_binary_ctc_loss if binary
           else jlosses.no_blank_ctc_loss)
    tfn = (tlosses.no_blank_binary_ctc_loss if binary
           else tlosses.no_blank_ctc_loss)
    cot = rng.standard_normal(logits.shape[1]).astype(np.float32)

    def jax_obj(x):
        out = jfn(x, jnp.asarray(paths), jnp.asarray(in_len),
                  jnp.asarray(tgt_len), reduction=reduction,
                  implementation="xla")
        return jnp.sum(out * cot) if reduction == "none" else out

    v_j, g_j = jax.value_and_grad(jax_obj)(jnp.asarray(logits))
    x = torch.tensor(logits, requires_grad=True)
    out = tfn(x, torch.tensor(paths), torch.tensor(in_len),
              torch.tensor(tgt_len), reduction=reduction)
    v_t = (out * torch.tensor(cot)).sum() if reduction == "none" else out
    v_t.backward()
    np.testing.assert_allclose(float(v_t.detach()), float(v_j), **VAL_TOL)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(g_j), **GRAD_TOL)


@pytest.mark.parametrize("kind", ["ce", "bce", "mlce"])
def test_final_step_losses_match(rng, kind):
    T, B, C = 6, 7, 9
    logits = (2.0 * rng.standard_normal((T, B, C))).astype(np.float32)
    if kind == "ce":
        target = rng.integers(0, C, size=B).astype(np.int32)
    else:
        target = (rng.random((B, C)) < 0.3).astype(np.float32)
    lens = np.ones(B, np.int64)

    def jax_obj(x):
        return jlosses.LOSS_FNS[kind](x, jnp.asarray(target), lens, lens)

    v_j, g_j = jax.value_and_grad(jax_obj)(jnp.asarray(logits))
    x = torch.tensor(logits, requires_grad=True)
    v_t = tlosses.LOSS_FNS[kind](x, torch.tensor(target), torch.tensor(lens),
                                 torch.tensor(lens))
    v_t.backward()
    np.testing.assert_allclose(float(v_t.detach()), float(v_j), **VAL_TOL)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(g_j), **VAL_TOL)


@pytest.mark.parametrize("kind,item", [("blank", "item 7"),
                                       ("joint", "item 8")])
def test_unported_losses_raise(kind, item):
    with pytest.raises(NotImplementedError, match=item):
        tlosses.LOSS_FNS[kind](torch.zeros(2, 2, 3), None, None, None)
