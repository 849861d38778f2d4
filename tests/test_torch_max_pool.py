"""The TF-same max pool kernels (``csrc/max_pool3d_same.cu``) against their
plain version on the card (``-m cuda``), and the op's CPU path.

On the card, at the 13 pools' shapes of a frozen step (100 clips of 10 x
224 x 224) and of 3 clips of 7 x 45 x 45 (ragged tiles), in float32,
bfloat16 and float64, NCDHW and ``channels_last_3d``: the forward equals
the plain version exactly and comes out in the memory format of its
``F.max_pool3d``; the gradient equals the plain version's exactly under an
integer cotangent (every sum of at most 27 such terms is exact in any order
and in every dtype) and is the same in two backward runs; under a normal
cotangent the float32 gradient lies within the rounding of at most 27 terms
(27 x 2^-24 of their absolute sum) of the plain version's in float64.  Ties
route where ``F.max_pool3d`` routes them (the first maximum in scan order),
NaN propagates (and routes to the last NaN, as there), no offsets are kept
without autograd, an unsupported input raises, and one ``InceptionI3d``
step launches each kernel 13 times with every pool's output in the layout
that the plain version gives.  On the CPU: the op is its plain version
there, the kernel's wrapper refuses what no kernel is built for, and every
cell pool takes a built tile in either layout.  No JAX here: the card's
machine has none.
"""

import pytest
import torch

from ctc_tpu_torch.models.i3d import InceptionI3d, pool_shapes
from ctc_tpu_torch.ops import max_pool as mp

DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16, "f64": torch.float64}
FORMATS = {"ncdhw": torch.contiguous_format, "cl3d": torch.channels_last_3d}
POOL_SETS = {"cells": pool_shapes(100), "ragged": pool_shapes(3, 7, 45)}
# the I3D's windows at small shapes: channels under one 32-channel block
# (8) and off it (40; each a multiple of 16 bytes in every dtype), odd and
# even sides, a plane tile of 16 (the (1, 3, 3) backward's), one plane
SMALL = [((1, 3, 3), (1, 2, 2), (2, 8, 3, 9, 8)),
         ((1, 3, 3), (1, 2, 2), (1, 40, 2, 16, 32)),
         ((3, 3, 3), (2, 2, 2), (2, 40, 5, 7, 8)),
         ((3, 3, 3), (2, 2, 2), (1, 8, 1, 2, 3)),
         ((2, 2, 2), (2, 2, 2), (3, 8, 3, 7, 6)),
         ((3, 3, 3), (1, 1, 1), (2, 40, 5, 6, 7)),
         ((3, 3, 3), (1, 1, 1), (1, 8, 1, 2, 1))]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _input(shape, dtype, fmt, seed, device, kind="normal"):
    gen = torch.Generator(device).manual_seed(seed)
    x = torch.randn(shape, generator=gen, device=device)
    if kind == "zeros":
        x.zero_()
    elif kind == "repeats":
        x = torch.round(x).clamp(min=0)  # post-ReLU: many equal zeros, ones
    elif kind == "nan":
        x[torch.rand(shape, generator=gen, device=device) < 0.05] = \
            float("nan")
        x.view(-1)[0] = float("nan")
    return x.to(dtype).contiguous(memory_format=FORMATS[fmt])


def _integer_cotangent(y, seed):
    gen = torch.Generator(y.device).manual_seed(seed)
    return torch.randint(1, 9, y.shape, generator=gen, device=y.device).to(
        y.dtype)


def _against_plain(x, kernel, stride, seed):
    """The kernel's and the plain version's output and gradient (under an
    integer cotangent) from the same input; the second backward's too."""
    x = x.detach().requires_grad_()
    ref = x.detach().clone().requires_grad_()
    y = mp.max_pool3d_same(x, kernel, stride)
    want = mp.max_pool3d_same_plain(ref, kernel, stride)
    gy = _integer_cotangent(y, seed)
    (gx,) = torch.autograd.grad(y, x, gy, retain_graph=True)
    (again,) = torch.autograd.grad(y, x, gy)
    (want_gx,) = torch.autograd.grad(want, ref, gy)
    torch.cuda.synchronize()
    return y, want, gx, again, want_gx


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", list(FORMATS))
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("index", range(13))
@pytest.mark.parametrize("pools", list(POOL_SETS))
def test_kernel_matches_plain_at_the_pools_shapes(cuda_device, pools, index,
                                                  dtype, fmt):
    _, shape, kernel, stride = POOL_SETS[pools][index]
    x = _input(shape, DTYPES[dtype], fmt, index, cuda_device)
    y, want, gx, again, want_gx = _against_plain(x, kernel, stride, index)
    torch.testing.assert_close(y, want, rtol=0, atol=0)
    assert y.stride() == want.stride()
    torch.testing.assert_close(gx, want_gx, rtol=0, atol=0)
    assert torch.equal(gx, again)


@pytest.mark.cuda
@pytest.mark.parametrize("index", range(13))
def test_float32_gradient_within_its_rounding(cuda_device, index):
    """A normal cotangent at the cells' shapes, channels last: each input's
    sum of at most 27 float32 terms, in the kernel's order, against the
    plain version in float64."""
    _, shape, kernel, stride = POOL_SETS["cells"][index]
    x = _input(shape, torch.float32, "cl3d", index, cuda_device)
    x.requires_grad_()
    y = mp.max_pool3d_same(x, kernel, stride)
    gy = torch.randn(y.shape, device=cuda_device,
                     generator=torch.Generator(cuda_device).manual_seed(7))
    (gx,) = torch.autograd.grad(y, x, gy)
    ref = x.detach().double().requires_grad_()
    want = mp.max_pool3d_same_plain(ref, kernel, stride)
    (want_gx,) = torch.autograd.grad(want, ref, gy.double(),
                                     retain_graph=True)
    (abs_sum,) = torch.autograd.grad(want, ref, gy.double().abs())
    err = (gx.double() - want_gx).abs()
    assert bool((err <= 27 * 2.0 ** -24 * abs_sum + 1e-300).all())
    torch.testing.assert_close(gx.double(), want_gx, rtol=1e-6,
                               atol=27 * 2.0 ** -24 * float(abs_sum.max()))


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", list(FORMATS))
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("kind", ["zeros", "repeats", "nan"])
@pytest.mark.parametrize("case", range(len(SMALL)))
def test_ties_and_nan_route_as_plain(cuda_device, case, kind, dtype, fmt):
    """All-zero and post-ReLU repeated inputs route each window to the
    element F.max_pool3d picks; NaN propagates, to the same element."""
    kernel, stride, shape = SMALL[case]
    x = _input(shape, DTYPES[dtype], fmt, case, cuda_device, kind)
    y, want, gx, again, want_gx = _against_plain(x, kernel, stride, case)
    torch.testing.assert_close(y, want, rtol=0, atol=0, equal_nan=True)
    assert y.stride() == want.stride()
    if kind == "nan":
        assert bool(torch.isnan(y).any())
    torch.testing.assert_close(gx, want_gx, rtol=0, atol=0)
    assert torch.equal(gx, again)


@pytest.mark.cuda
def test_offsets_only_where_autograd_needs_them(cuda_device):
    """Under no_grad, and for an input that does not require grad, the
    forward allocates only its output and leaves no graph; with a backward
    to come it keeps one uint8 an output and no copy of the input."""
    kernel, stride, shape = SMALL[5]
    x = _input(shape, torch.float32, "cl3d", 0, cuda_device)
    out_bytes = x.numel() * 4  # stride 1: as many outputs as inputs
    for grad_mode, requires in ((False, True), (True, False)):
        x.requires_grad_(requires)
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        with torch.set_grad_enabled(grad_mode):
            y = mp.max_pool3d_same(x, kernel, stride)
        torch.cuda.synchronize()
        assert y.grad_fn is None
        grew = torch.cuda.memory_allocated() - before
        assert grew == -(-out_bytes // 512) * 512
        del y
    x.requires_grad_()
    y = mp.max_pool3d_same(x, kernel, stride)
    (offsets,) = y.grad_fn.saved_tensors
    assert offsets.dtype == torch.uint8 and offsets.shape == y.shape
    assert offsets.stride() == y.stride()
    assert int(offsets.max()) < 27


@pytest.mark.cuda
def test_unsupported_inputs_raise(cuda_device):
    x = torch.zeros((1, 8, 3, 4, 5), device=cuda_device)
    for dtype in (torch.float16, torch.int32):
        with pytest.raises(TypeError, match="no kernel"):
            mp.max_pool3d_same(x.to(dtype), (3, 3, 3), (1, 1, 1))
    with pytest.raises(ValueError, match=r"\[N, C, D, H, W\]"):
        mp.max_pool3d_same(x[0], (3, 3, 3), (1, 1, 1))
    with pytest.raises(ValueError, match="no kernel for window"):
        mp.max_pool3d_same(x, (4, 3, 3), (1, 1, 1))
    with pytest.raises(ValueError, match="multiple of 16 bytes"):
        mp.max_pool3d_same(x[:, :6], (3, 3, 3), (1, 1, 1))
    with pytest.raises(ValueError, match="offsets on"):
        mp.max_pool3d_same_grad_kernel(
            torch.zeros((1, 8, 3, 4, 5)),
            torch.zeros((1, 8, 3, 4, 5), dtype=torch.uint8,
                        device=cuda_device),
            (1, 8, 3, 4, 5), (3, 3, 3), (1, 1, 1))


@pytest.mark.cuda
def test_i3d_step_launches_13_pools_in_the_plain_layouts(cuda_device,
                                                         monkeypatch):
    """One train step of InceptionI3d on one 10 x 224 x 224 clip launches
    the forward kernel 13 times and the backward 13 times; every pool's
    output has the strides of the plain version's on the same input."""
    from ctc_tpu_torch.models import i3d

    strides = []

    def recording(x, kernel, stride):
        y = mp.max_pool3d_same(x, kernel, stride)
        with torch.no_grad():
            want = mp.max_pool3d_same_plain(x, kernel, stride)
        strides.append((y.stride(), want.stride()))
        return y

    model = InceptionI3d(num_classes=None).to(cuda_device)
    clips = torch.randn((1, 1, 10, 224, 224, 3), device=cuda_device)
    mp.reset_launch_counts()
    with torch.no_grad():
        model(clips)
    assert mp.launch_counts == {"max_pool3d_same_forward": 13,
                                "max_pool3d_same_backward": 0}
    mp.reset_launch_counts()
    monkeypatch.setattr(i3d, "max_pool3d_same", recording)
    model(clips, train=True).sum().backward()
    torch.cuda.synchronize()
    assert mp.launch_counts == {"max_pool3d_same_forward": 13,
                                "max_pool3d_same_backward": 13}
    assert len(strides) == 13
    assert all(got == want for got, want in strides)


# ---------------------------------------------------------------------------
# on the CPU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", range(len(SMALL)))
def test_cpu_path_is_the_plain_version(case):
    """On a CPU tensor the op is its plain version, gradient included, and
    launches nothing (two channels: gradcheck's Jacobian is dense)."""
    kernel, stride, shape = SMALL[case]
    x = torch.randn((shape[0], 2, *shape[2:]), dtype=torch.float64,
                    generator=torch.Generator().manual_seed(case),
                    requires_grad=True)
    mp.reset_launch_counts()
    y = mp.max_pool3d_same(x, kernel, stride)
    torch.testing.assert_close(y, mp.max_pool3d_same_plain(x, kernel, stride),
                               rtol=0, atol=0)
    assert torch.autograd.gradcheck(
        lambda v: mp.max_pool3d_same(v, kernel, stride), (x,))
    assert not any(mp.launch_counts.values())


@pytest.mark.parametrize("fmt", list(FORMATS))
@pytest.mark.parametrize("shape", [(2, 5, 3, 4, 6), (2, 1, 3, 4, 6),
                                   (2, 5, 1, 1, 1), (1, 5, 3, 4, 6),
                                   (2, 5, 1, 4, 1), (1, 1, 1, 1, 1)])
def test_channels_last_reads_the_strides_as_aten_does(shape, fmt):
    """:func:`channels_last` is ``suggest_memory_format`` on the strides,
    size-1 dims included, the format ATen gives F.max_pool3d's output: seen
    here through ``torch.cat`` along C, which ATen allocates in its inputs'
    suggested format with twice the channels."""
    x = torch.zeros(shape).contiguous(memory_format=FORMATS[fmt])
    assert torch.cat([x, x], 1).is_contiguous() != mp.channels_last(x)


@pytest.mark.parametrize("dtype,shape,kernel,stride,error", [
    (torch.float16, (1, 8, 3, 4, 5), (3, 3, 3), (1, 1, 1), "no kernel for"),
    (torch.int32, (1, 8, 3, 4, 5), (3, 3, 3), (1, 1, 1), "no kernel for"),
    (torch.float32, (8, 3, 4, 5), (3, 3, 3), (1, 1, 1), r"\[N, C, D, H, W\]"),
    (torch.float32, (1, 8, 3, 4, 5), (4, 3, 3), (1, 1, 1), "no kernel for w"),
    (torch.float32, (1, 8, 3, 4, 5), (3, 3, 3), (1, 2, 2), "no kernel for w"),
    (torch.float32, (1, 6, 3, 4, 5), (3, 3, 3), (1, 1, 1), "16 bytes"),
    (torch.bfloat16, (1, 36, 3, 4, 5), (3, 3, 3), (2, 2, 2), "16 bytes"),
    (torch.float64, (1, 3, 3, 4, 5), (1, 3, 3), (1, 2, 2), "16 bytes"),
])
def test_kernel_refuses_what_no_kernel_is_built_for(dtype, shape, kernel,
                                                    stride, error):
    """The wrapper raises before it looks for a card: a dtype, rank,
    window or channel count that no kernel takes."""
    x = torch.zeros(shape, dtype=dtype)
    with pytest.raises((TypeError, ValueError), match=error):
        mp.max_pool3d_same_kernel(x, kernel, stride, with_offsets=False)


@pytest.mark.parametrize("name,shape,kernel,stride", pool_shapes(100),
                         ids=[p[0] for p in pool_shapes(100)])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("fmt", list(FORMATS))
def test_tile_plan_fits_the_kernel(name, shape, kernel, stride, dtype, fmt):
    """Every cell pool, in either layout, is one the kernels take: its
    layout read from the strides, its tile one that its window's forward is
    built for, whose two buffers of a plane's tile (32 channels) fit in the
    227 KB of shared memory a block may use."""
    x = torch.empty(shape, dtype=DTYPES[dtype], device="meta",
                    memory_format=FORMATS[fmt])
    assert mp.channels_last(x) == (fmt == "cl3d")
    mp._require(x, kernel, stride)
    out = [-(-n // s) for n, s in zip(shape[2:], stride)]
    th, tw = mp.tile_plan(tuple(out[1:]), kernel, stride)
    assert (th, tw) in mp.TILES[(kernel, stride)]
    ih, iw = (th - 1) * stride[1] + kernel[1], (tw - 1) * stride[2] + kernel[2]
    assert 2 * ih * iw * 32 * x.element_size() <= 227 * 1024
