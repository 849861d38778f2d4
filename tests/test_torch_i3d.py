"""ctc_tpu_torch's I3D against ctc_tpu's flax I3D on the CPU, from the same
weights.

The weights are the port's own random ones with BatchNorm parameters and
statistics drawn from a seed, so every layer is non-trivial.  Their
``state_dict`` is in the reference PyTorch I3D's key layout: ctc_tpu reads
it through its ``convert_torch_state_dict`` and the port through
``load_state_dict``, and ``i3d_from_jax`` carries the flax trees back.

Tolerance: the JAX suite's own for its I3D against the reference
(``tests/test_i3d.py``), rtol 1e-3 and atol 2e-4; both sides are f32 on the
CPU and differ in the summation order of the convolutions (measured on
two clips: at most 6e-7 absolute in eval mode, at ``Mixed_3c`` on 56 x 56
and on the full chain at 224 x 224; 8e-6 at ``Mixed_3c`` in train mode,
where every layer normalizes by its batch statistics).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ctc_tpu.models.i3d import InceptionI3d as JaxI3d
from ctc_tpu.models.i3d import InceptionModule as JaxInception
from ctc_tpu.models.i3d import _max_pool_same as jax_max_pool_same
from ctc_tpu.models.i3d import Unit3D as JaxUnit3D
from ctc_tpu.models.i3d import convert_torch_state_dict
from ctc_tpu_torch.models import (
    InceptionI3d,
    InceptionModule,
    Unit3D,
    i3d_from_jax,
)
from ctc_tpu_torch.models.i3d import ENDPOINTS, same_pads
from ctc_tpu_torch.ops.max_pool import max_pool3d_same

TOL = dict(rtol=1e-3, atol=2e-4)


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def randomize_bn(module, seed):
    """Non-trivial BatchNorm scale, bias and running statistics."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, t in module.state_dict().items():
            n = t.shape
            if name.endswith("bn.weight"):
                t.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, n)))
            elif name.endswith("bn.bias") or name.endswith("running_mean"):
                t.copy_(torch.from_numpy(rng.normal(0, 0.1, n)))
            elif name.endswith("running_var"):
                t.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, n)))
    return module


def port_i3d(seed=0, **kw):
    model = InceptionI3d(**kw)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    return randomize_bn(model, seed)


def clips(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("n,k,s,want", [
    (10, 7, 2, (2, 3)), (9, 7, 2, (3, 3)), (224, 7, 2, (2, 3)),
    (5, 3, 1, (1, 1)), (4, 1, 1, (0, 0)), (56, 3, 2, (0, 1)),
    (5, 2, 2, (0, 1)), (4, 2, 2, (0, 0)),
])
def test_same_pads_follow_xla(n, k, s, want):
    """XLA's SAME padding: total (ceil(n/s) - 1) s + k - n, half in front;
    Conv3d_1a_7x7 on 10 frames pads 2 before and 3 after."""
    assert same_pads((n,), (k,), (s,)) == want


# the five pool cases of ENDPOINTS, each on a small [D, H, W] with odd and
# even sides (MaxPool3d_2a and _3a share a window and stride, at other sizes)
POOLS = {name: spec[1:] for name, spec in ENDPOINTS if spec[0] == "pool"}
POOL_CASES = [
    ("MaxPool3d_2a_3x3", (5, 23, 22)),
    ("MaxPool3d_3a_3x3", (5, 12, 11)),
    ("MaxPool3d_4a_3x3", (5, 8, 7)),
    ("MaxPool3d_5a_2x2", (3, 7, 6)),
    ("Mixed_b3", (5, 7, 6)),
]


@pytest.mark.parametrize("name,size", POOL_CASES,
                         ids=[name for name, _ in POOL_CASES])
def test_max_pool_same_matches_jax(name, size):
    """The plain TF-same pool (the CPU path, the kernel's oracle) against
    ctc_tpu's reduce_window on inputs of both signs, so the -inf padding is
    held and not only its zero-padding special case; and its gradient
    through torch.autograd against jax.vjp under an integer cotangent,
    whose sums are exact in any order."""
    kernel, stride = POOLS.get(name, ((3, 3, 3), (1, 1, 1)))
    x = clips((2, *size, 4), 11) - 1.0  # mostly negative: border maxima
    want, vjp = jax.vjp(lambda v: jax_max_pool_same(v, kernel, stride),
                        jnp.asarray(x))
    xt = torch.from_numpy(x).permute(0, 4, 1, 2, 3).requires_grad_()
    got = max_pool3d_same(xt, kernel, stride)
    np.testing.assert_array_equal(
        got.permute(0, 2, 3, 4, 1).detach().numpy(), np.asarray(want))
    cot = np.random.default_rng(12).integers(1, 9, want.shape).astype(
        np.float32)
    (want_grad,) = vjp(jnp.asarray(cot))
    (grad,) = torch.autograd.grad(
        got, xt, torch.from_numpy(cot).permute(0, 4, 1, 2, 3))
    np.testing.assert_array_equal(grad.permute(0, 2, 3, 4, 1).numpy(),
                                  np.asarray(want_grad))


@pytest.mark.parametrize("kernel,stride,size", [
    ((3, 3, 3), (1, 1, 1), (5, 9, 8)),
    ((3, 3, 3), (2, 2, 2), (5, 9, 8)),
    ((7, 7, 7), (2, 2, 2), (10, 11, 12)),
    ((1, 1, 1), (1, 1, 1), (4, 6, 6)),
    ((2, 3, 3), (2, 2, 2), (6, 7, 10)),
], ids=["k3s1", "k3s2-odd-even", "k7s2", "k1s1", "k233s2"])
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_unit3d_matches_jax(kernel, stride, size, train):
    """Unit3D at stride 1 and 2 on odd and even sizes (the asymmetric
    pad), in eval and in train mode (batch statistics, and the running
    statistics it leaves)."""
    x = clips((2, *size, 5), 1)
    jmod = JaxUnit3D(6, kernel, stride)
    variables = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))
    port = Unit3D(5, 6, kernel, stride)
    port.load_state_dict(i3d_from_jax(np_tree(variables["params"]),
                                      np_tree(variables["batch_stats"])))
    randomize_bn(port, 2)
    sd = port.state_dict()
    variables = convert_torch_state_dict(sd)
    want, mutated = jmod.apply(variables, jnp.asarray(x), train=train,
                               mutable=["batch_stats"])
    got = port(torch.from_numpy(x).permute(0, 4, 1, 2, 3), train=train)
    np.testing.assert_allclose(got.permute(0, 2, 3, 4, 1).detach().numpy(),
                               np.asarray(want), **TOL)
    stats = mutated["batch_stats"]["bn"]
    np.testing.assert_allclose(port.bn.running_mean.numpy(),
                               np.asarray(stats["mean"]), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(port.bn.running_var.numpy(),
                               np.asarray(stats["var"]), rtol=1e-5, atol=1e-6)


def test_inception_module_matches_jax():
    x = np.abs(clips((2, 4, 7, 7, 16), 3))  # post-ReLU input
    jmod = JaxInception((4, 5, 6, 3, 4, 5))
    variables = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))
    port = InceptionModule(16, (4, 5, 6, 3, 4, 5))
    port.load_state_dict(i3d_from_jax(np_tree(variables["params"]),
                                      np_tree(variables["batch_stats"])))
    randomize_bn(port, 4)
    want = jmod.apply(convert_torch_state_dict(port.state_dict()),
                      jnp.asarray(x))
    got = port(torch.from_numpy(x).permute(0, 4, 1, 2, 3))
    assert port.out_channels == 4 + 6 + 4 + 5
    np.testing.assert_allclose(got.permute(0, 2, 3, 4, 1).detach().numpy(),
                               np.asarray(want), **TOL)


@pytest.fixture(scope="module")
def mixed_3c():
    port = port_i3d(5, final_endpoint="Mixed_3c", num_classes=None)
    jmodel = JaxI3d(final_endpoint="Mixed_3c")
    return port, jmodel, convert_torch_state_dict(port.state_dict())


def test_state_dict_round_trips_through_jax(mixed_3c):
    """The reference-layout state dict through convert_torch_state_dict
    and back through i3d_from_jax is the same dict."""
    port, _, variables = mixed_3c
    back = i3d_from_jax(np_tree(variables["params"]),
                        np_tree(variables["batch_stats"]))
    sd = port.state_dict()
    assert set(back) == set(sd)
    for k, v in sd.items():
        torch.testing.assert_close(back[k], v, rtol=0, atol=0, msg=k)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_mixed_3c_chain_matches_jax(mixed_3c, train):
    """The chain to Mixed_3c on [2, 3, 10, 56, 56, 3] clips, T folded into
    the batch; in train mode the running statistics it leaves too."""
    port, jmodel, variables = mixed_3c
    port = InceptionI3d(final_endpoint="Mixed_3c", num_classes=None)
    port.load_state_dict(mixed_3c[0].state_dict())
    x = clips((2, 3, 10, 56, 56, 3), 6)
    want, mutated = jmodel.apply(variables, jnp.asarray(x), train=train,
                                 mutable=["batch_stats"])
    got = port(torch.from_numpy(x), train=train)
    assert got.shape == (2, 3, 480)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    back = i3d_from_jax(np_tree(variables["params"]),
                        np_tree(mutated["batch_stats"]))
    for k, v in port.state_dict().items():
        if "running" in k:
            np.testing.assert_allclose(v.numpy(), back[k].numpy(),
                                       rtol=1e-5, atol=1e-6, err_msg=k)


def test_single_clip_input_squeezes_t(mixed_3c):
    port = mixed_3c[0]
    x = torch.from_numpy(clips((2, 10, 56, 56, 3), 7))
    with torch.no_grad():
        torch.testing.assert_close(port(x), port(x[:, None])[:, 0])


def test_full_chain_and_logits_match_jax_on_a_224_clip():
    """The whole chain to Mixed_5c and the logits head on one 10 x 224 x
    224 clip: features [1, 1024] and logits [1, 400]."""
    port = port_i3d(8)
    variables = convert_torch_state_dict(port.state_dict())
    x = clips((1, 10, 224, 224, 3), 9)
    apply = jax.jit(lambda v, c: JaxI3d().apply(v, c, train=False,
                                                with_logits=True))
    want_logits, want = apply(variables, jnp.asarray(x))
    with torch.no_grad():
        logits, got = port(torch.from_numpy(x), with_logits=True)
    assert got.shape == (1, 1024) and logits.shape == (1, 400)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits),
                               **TOL)


def test_reference_checkpoint_loads_as_it_is(tmp_path):
    """A state dict in the reference's layout, saved with torch.save, loads
    into the port with load_state_dict (strict) and gives the features
    ctc_tpu gives from the same file through convert_torch_state_dict."""
    src = port_i3d(10, final_endpoint="Mixed_3c")
    path = tmp_path / "rgb_i3d.pt"
    torch.save(src.state_dict(), path)
    port = InceptionI3d(final_endpoint="Mixed_3c")
    port.load_state_dict(torch.load(path, weights_only=True))
    variables = convert_torch_state_dict(torch.load(path, weights_only=True))
    x = clips((1, 2, 10, 56, 56, 3), 11)
    want = JaxI3d(final_endpoint="Mixed_3c").apply(variables, jnp.asarray(x))
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_init_follows_flax():
    """reset_parameters: lecun_normal kernels (variance 1 / fan_in,
    truncated at 2 sigma), zero biases, BatchNorm scale 1, bias 0, mean 0,
    variance 1."""
    model = InceptionI3d(final_endpoint="Mixed_3c")
    model.reset_parameters(torch.Generator().manual_seed(0))
    w = model.Conv3d_2c_3x3.conv3d.weight
    fan_in = w[0].numel()
    assert abs(float(w.detach().std()) * np.sqrt(fan_in) - 1.0) < 0.05
    assert float(w.abs().max()) <= 2.0 / np.sqrt(fan_in) / 0.8796 + 1e-6
    assert float(model.logits.conv3d.bias.abs().max()) == 0.0
    bn = model.Mixed_3b.b1b.bn
    assert bool((bn.weight == 1).all() and (bn.bias == 0).all()
                and (bn.running_mean == 0).all()
                and (bn.running_var == 1).all())
