"""The port's kernels (Triton and CUDA C++) on the card against their plain
versions.

Marked `cuda`: these need an NVIDIA GPU with Triton and nvcc and skip
elsewhere. Run
them on the card with
`python -m pytest tests/test_torch_cuda.py -m cuda --noconftest`
(tests/conftest.py imports jax, which a GPU-only environment may lack).
"""

import itertools

import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the Triton and CUDA kernels have "
                    "no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("c", [3, 1])
def test_augment_kernel_matches_plain(cuda, c):
    from msml_torch.kernels.augment import (augment_batch,
                                            augment_batch_reference)

    gen = torch.Generator(device=cuda).manual_seed(0)
    img = torch.rand((16, 112, 112, c), generator=gen, device=cuda)
    noise = torch.randn(img.shape, generator=gen, device=cuda)
    draws = torch.rand((16, 6), generator=gen, device=cuda)
    before = augment_batch.launches
    for fill, relight, use_norm, (lo, hi) in itertools.product(
            ("black", "white", "gauss"), (False, True), (False, True),
            ((0, 1), (20, 51))):
        kw = dict(lo=lo, hi=hi, fill=fill, relight=relight,
                  use_norm=use_norm)
        out = augment_batch(img, draws, noise, **kw)
        ref = augment_batch_reference(img, draws, noise, **kw)
        torch.testing.assert_close(out, ref, atol=1e-5, rtol=0)
    assert augment_batch.launches == before + 24


def test_augment_kernel_block_area(cuda):
    from msml_torch.kernels.augment import augment_batch

    img = torch.full((32, 112, 112, 3), 0.5, device=cuda)
    draws = torch.rand((32, 6), device=cuda,
                       generator=torch.Generator(device=cuda).manual_seed(1))
    out = augment_batch(img, draws, lo=25, hi=26, fill="black",
                        use_norm=False)
    assert bool(((out == 0).all(1).sum((1, 2)) == 56 * 56).all())


@pytest.mark.parametrize("fill", ["black", "gauss"])
def test_augment_kernel_uint8_matches_plain(cuda, fill):
    """uint8 NHWC in: /255 in the same pass, then the f32 path; and the
    training input stage built on it."""
    from msml_torch.kernels.augment import (augment_batch,
                                            augment_batch_reference,
                                            device_input_stage)

    gen = torch.Generator(device=cuda).manual_seed(2)
    img = torch.randint(0, 256, (8, 112, 112, 3), generator=gen, device=cuda,
                        dtype=torch.uint8)
    noise = torch.randn(img.shape, generator=gen, device=cuda)
    draws = torch.rand((8, 6), generator=gen, device=cuda)
    for relight, (lo, hi) in itertools.product((False, True),
                                               ((0, 1), (20, 51))):
        kw = dict(lo=lo, hi=hi, fill=fill, relight=relight)
        torch.testing.assert_close(
            augment_batch(img, draws, noise, **kw),
            augment_batch_reference(img, draws, noise, **kw),
            atol=1e-5, rtol=0)
    before = augment_batch.launches
    out = device_input_stage(img, draws[:, 3:].contiguous())
    assert augment_batch.launches == before + 1
    six = torch.cat([torch.zeros_like(draws[:, :3]), draws[:, 3:]], 1)
    torch.testing.assert_close(
        out, augment_batch_reference(img, six, relight=True), atol=1e-5,
        rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.uint8])
@pytest.mark.parametrize("shape", [(3, 113, 17, 3), (5, 9, 21, 1)])
def test_augment_kernel_odd_misaligned(cuda, shape, dtype):
    """Odd H and W (copies of one element or 8 bytes, stores of one or two
    floats, empty bands at H = 9) on an input that starts one element
    past an aligned address, and two runs bit-equal."""
    from msml_torch.kernels.augment import (augment_batch,
                                            augment_batch_reference)

    gen = torch.Generator(device=cuda).manual_seed(4)
    x = torch.rand(shape, generator=gen, device=cuda)
    if dtype == torch.uint8:
        x = (x * 256).to(torch.uint8)
    flat = torch.empty(x.numel() + 1, dtype=dtype, device=cuda)
    img = flat[1:].view(shape).copy_(x)
    noise = torch.randn(shape, generator=gen, device=cuda)
    draws = torch.rand((shape[0], 6), generator=gen, device=cuda)
    for fill, relight in itertools.product(("black", "white", "gauss"),
                                           (False, True)):
        kw = dict(lo=20, hi=51, fill=fill, relight=relight)
        out = augment_batch(img, draws, noise, **kw)
        torch.testing.assert_close(
            out, augment_batch_reference(img, draws, noise, **kw),
            atol=1e-5, rtol=0)
        assert torch.equal(out, augment_batch(img, draws, noise, **kw))


PRELU_SHAPES = [(64, 112, 112), (32, 56, 56), (256, 14, 14), (512, 7, 7),
                (512, 4, 4), (5, 3, 3)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", PRELU_SHAPES)
def test_prelu_kernels_match_plain(cuda, dtype, shape):
    """y and dx equal, dalpha relative L2 error <= 1e-5 (f32) or 1e-3
    (bf16): the kernels sum in another order."""
    from msml_torch.kernels.prelu import (prelu_bwd, prelu_bwd_reference,
                                          prelu_fwd, prelu_reference)

    gen = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn((6,) + shape, generator=gen, device=cuda)
    x[torch.rand(x.shape, generator=gen, device=cuda) < 0.1] = 0.0
    x = x.to(dtype)
    g = torch.randn(x.shape, generator=gen, device=cuda).to(dtype)
    a = torch.rand((shape[0],), generator=gen, device=cuda) * 0.5
    f0, b0 = prelu_fwd.launches, prelu_bwd.launches
    y = prelu_fwd(x, a)
    dx, da = prelu_bwd(g, x, a)
    assert (prelu_fwd.launches, prelu_bwd.launches) == (f0 + 1, b0 + 1)
    dx_ref, da_ref = prelu_bwd_reference(g, x, a)
    assert torch.equal(y, prelu_reference(x, a))
    assert torch.equal(dx, dx_ref)
    tol = 1e-5 if dtype == torch.float32 else 1e-3
    assert ((da - da_ref).norm() / da_ref.norm()).item() <= tol


def test_prelu_autograd_under_autocast(cuda):
    """The Function takes autocast's bf16 activations as they are and
    returns an f32 slope gradient; equal to autograd through the plain
    version, which rounds its dalpha products and sum to bf16: relative L2
    error <= 2e-2."""
    from msml_torch.kernels.prelu import prelu_reference
    from msml_torch.nn.common import PReLU

    gen = torch.Generator(device=cuda).manual_seed(4)
    conv = torch.nn.Conv2d(3, 16, 3, padding=1).to(cuda)
    m = PReLU(16).to(cuda)
    x = torch.randn((4, 3, 20, 20), generator=gen, device=cuda)
    grads = []
    for fn in (m, lambda v: prelu_reference(v, m.weight)):
        m.weight.grad = None
        with torch.autocast("cuda", dtype=torch.bfloat16):
            h = conv(x)
            assert h.dtype == torch.bfloat16
            y = fn(h)
        assert y.dtype == torch.bfloat16
        y.float().square().sum().backward()
        grads.append(m.weight.grad.clone())
    assert grads[0].dtype == torch.float32
    assert ((grads[0] - grads[1]).norm() / grads[1].norm()).item() <= 2e-2


CONV_SHAPES = [(4, 112, 112), (4, 56, 56), (4, 28, 28), (3, 13, 17),
               (2, 5, 130)]


def _rel(a, b):
    return ((a.double() - b.double()).norm() / b.double().norm()).item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", CONV_SHAPES)
def test_conv3x3_kernels_match_plain(cuda, dtype, shape):
    """Forward, dX (the forward on flipped weights) and dW against the
    plain versions in f32 on the same inputs. Relative L2 error: f32
    forward and dX <= 1e-5, dW <= 1e-4 (sums in another order); bf16
    forward and dX <= 5e-3 (one rounding of the output), dW <= 1e-3."""
    from msml_torch.kernels.conv3x3 import (conv3x3_dw, conv3x3_dw_reference,
                                            conv3x3_fwd, conv3x3_reference,
                                            flip_weights)

    n, h, w = shape
    gen = torch.Generator(device=cuda).manual_seed(5)
    x = torch.randn((n, 64, h, w), generator=gen, device=cuda).to(dtype)
    dy = torch.randn((n, 64, h, w), generator=gen, device=cuda).to(dtype)
    wt = (torch.randn((64, 64, 3, 3), generator=gen, device=cuda)
          / 24).to(dtype)
    wf = flip_weights(wt).contiguous()
    f0, d0 = conv3x3_fwd.launches, conv3x3_dw.launches
    y, dx, dw = conv3x3_fwd(x, wt), conv3x3_fwd(dy, wf), conv3x3_dw(x, dy)
    torch.cuda.synchronize()
    assert (conv3x3_fwd.launches, conv3x3_dw.launches) == (f0 + 2, d0 + 1)
    assert y.dtype == dx.dtype == dtype and dw.dtype == torch.float32
    f32 = dtype == torch.float32
    assert _rel(y, conv3x3_reference(x.float(), wt.float())) <= (
        1e-5 if f32 else 5e-3)
    assert _rel(dx, conv3x3_reference(dy.float(), wf.float())) <= (
        1e-5 if f32 else 5e-3)
    assert _rel(dw, conv3x3_dw_reference(x.float(), dy.float())) <= (
        1e-4 if f32 else 1e-3)
    assert torch.equal(dw, conv3x3_dw(x, dy))  # no atomics: same bits


DW_BF16_SHAPES = [(4, 112, 112), (4, 56, 56), (4, 28, 28), (3, 9, 17),
                  (3, 27, 28), (2, 7, 57), (2, 5, 113), (2, 4, 200),
                  (140, 3, 8)]


@pytest.mark.parametrize("shape", DW_BF16_SHAPES)
@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "offset"])
def test_conv3x3_dw_bf16_rows_match_plain(cuda, shape, offset):
    """The bf16 dW kernel (row rings, strips, every staging width: tensors
    that start one element past an aligned address take the 2-byte path)
    against the plain version in f32: relative L2 error <= 1e-3; two runs
    bit-equal."""
    from msml_torch.kernels.conv3x3 import (conv3x3_dw, conv3x3_dw_reference,
                                            dw_vector)

    n, h, w = shape
    gen = torch.Generator(device=cuda).manual_seed(7)
    numel = n * 64 * h * w
    x, dy = (torch.randn((numel + offset,), generator=gen, device=cuda)
             .to(torch.bfloat16)[offset:].view(n, 64, h, w) for _ in range(2))
    assert offset == 0 or dw_vector(w, x, dy) == 1
    d0 = conv3x3_dw.launches
    dw = conv3x3_dw(x, dy)
    again = conv3x3_dw(x, dy)
    torch.cuda.synchronize()
    assert conv3x3_dw.launches == d0 + 2
    assert _rel(dw, conv3x3_dw_reference(x.float(), dy.float())) <= 1e-3
    assert torch.equal(dw, again)


FWD_BF16_SHAPES = [(4, 112, 112), (4, 56, 56), (4, 28, 28), (4, 9, 17),
                   (4, 27, 28), (4, 7, 57), (2, 5, 113), (2, 4, 200),
                   (140, 3, 8)]


@pytest.mark.parametrize("shape", FWD_BF16_SHAPES)
@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "offset"])
def test_conv3x3_fwd_bf16_rows_match_plain(cuda, shape, offset):
    """The bf16 forward kernel (persistent row ring, strips, every staging
    width: tensors one element past an aligned address take the 2-byte
    path; odd W stores one element at a time), forward and dX, against the
    plain version in f32: relative L2 error <= 5e-3 (one rounding of the
    output); two runs bit-equal."""
    from msml_torch.kernels.conv3x3 import (conv3x3_fwd, conv3x3_reference,
                                            dw_vector, flip_weights)

    n, h, w = shape
    gen = torch.Generator(device=cuda).manual_seed(8)
    numel = n * 64 * h * w
    x, dy = (torch.randn((numel + offset,), generator=gen, device=cuda)
             .to(torch.bfloat16)[offset:].view(n, 64, h, w) for _ in range(2))
    assert offset == 0 or dw_vector(w, x, dy) == 1
    wt = (torch.randn((64, 64, 3, 3), generator=gen, device=cuda)
          / 24).to(torch.bfloat16)
    wf = flip_weights(wt).contiguous()
    f0 = conv3x3_fwd.launches
    y, again, dx = conv3x3_fwd(x, wt), conv3x3_fwd(x, wt), conv3x3_fwd(dy, wf)
    torch.cuda.synchronize()
    assert conv3x3_fwd.launches == f0 + 3
    assert _rel(y, conv3x3_reference(x.float(), wt.float())) <= 5e-3
    assert _rel(dx, conv3x3_reference(dy.float(), wf.float())) <= 5e-3
    assert torch.equal(y, again)


def test_conv3x3_autograd_under_autocast(cuda):
    """A routed Conv3x3 under bf16 autocast: bf16 output and dX, f32 weight
    gradient; against F.conv2d under the same autocast (cuDNN), relative L2
    error <= 1e-2 (both round to bf16 at other places)."""
    import torch.nn.functional as F

    from msml_torch.kernels.conv3x3 import conv3x3_dw, conv3x3_fwd
    from msml_torch.nn.common import conv3x3

    gen = torch.Generator(device=cuda).manual_seed(6)
    conv = conv3x3(64, 64).to(cuda)
    assert conv.routed
    with torch.no_grad():
        conv.weight.copy_(torch.randn(conv.weight.shape, generator=gen,
                                      device=cuda) / 24)
    x = torch.randn((4, 64, 28, 28), generator=gen, device=cuda)
    g = torch.randn((4, 64, 28, 28), generator=gen, device=cuda)
    outs = []
    for fn in (conv, lambda v: F.conv2d(v, conv.weight, padding=1)):
        conv.weight.grad = None
        xr = x.clone().requires_grad_()
        f0, d0 = conv3x3_fwd.launches, conv3x3_dw.launches
        with torch.autocast("cuda", dtype=torch.bfloat16):
            y = fn(xr)
        assert y.dtype == torch.bfloat16
        y.float().backward(g)
        outs.append((y, xr.grad, conv.weight.grad.clone(),
                     conv3x3_fwd.launches - f0, conv3x3_dw.launches - d0))
    (y, dx, dw, nf, nd), (y_ref, dx_ref, dw_ref, nf_ref, nd_ref) = outs
    assert (nf, nd, nf_ref, nd_ref) == (2, 1, 0, 0)
    assert dw.dtype == torch.float32
    assert _rel(y, y_ref) <= 1e-2
    assert _rel(dx, dx_ref) <= 1e-2
    assert _rel(dw, dw_ref) <= 1e-2


def test_conv3x3_kernel_refuses_what_it_does_not_take(cuda):
    from msml_torch.kernels.conv3x3 import conv3x3_fwd

    w = torch.zeros((32, 32, 3, 3), device=cuda)
    with pytest.raises(ValueError, match="64 channels"):
        conv3x3_fwd(torch.zeros((1, 32, 8, 8), device=cuda), w)
    w = torch.zeros((64, 64, 3, 3), device=cuda)
    x = torch.zeros((1, 64, 8, 16), device=cuda)[..., ::2]
    with pytest.raises(ValueError, match="contiguous"):
        conv3x3_fwd(x, w)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        conv3x3_fwd(torch.zeros((1, 64, 8, 8), device=cuda,
                                dtype=torch.float16), w.half())


@pytest.mark.parametrize("op", ["conv3x3_fwd", "prelu_fwd"])
def test_custom_ops_launch_the_kernels(cuda, op):
    """`torch.ops.msml_torch.<op>` on CUDA tensors launches the kernel (its
    count rises by one) and equals the plain version, as an exported
    program calls it."""
    from msml_torch.kernels import conv3x3, prelu

    gen = torch.Generator(device=cuda).manual_seed(4)
    x = torch.randn((2, 64, 28, 28), generator=gen, device=cuda).bfloat16()
    if op == "conv3x3_fwd":
        other = (torch.randn((64, 64, 3, 3), generator=gen, device=cuda)
                 / 24).bfloat16()
        wrapper = conv3x3.conv3x3_fwd
        want = conv3x3.conv3x3_reference(x.float(), other.float()).bfloat16()
        tol = dict(atol=3e-2, rtol=2e-2)
    else:
        other = torch.rand((64,), generator=gen, device=cuda)
        wrapper = prelu.prelu_fwd
        want = prelu.prelu_reference(x, other)
        tol = dict(atol=0, rtol=0)
    before = wrapper.launches
    got = getattr(torch.ops.msml_torch, op)(x, other)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    torch.testing.assert_close(got, want, **tol)


# (N, C_in, H, W, C_out, geometry) of the int8 conv; geometry (kh, kw, sh,
# sw, ph, pw, dh, dw, ho, wo): flagship shapes at small N, odd sizes, the
# transposed convs' lhs dilation (phases of unequal size where ho or wo is
# odd), Co on the 32- and 64-row tiles, pixel tails, the fc as a 1 x 1
# conv with a split K
QCONV_CASES = {
    "3x3_s1": (3, 64, 15, 17, 64, (3, 3, 1, 1, 1, 1, 1, 1, 15, 17)),
    "3x3_s2": (2, 146, 14, 14, 128, (3, 3, 2, 2, 1, 1, 1, 1, 7, 7)),
    "1x1_s2": (2, 64, 9, 9, 128, (1, 1, 2, 2, 0, 0, 1, 1, 5, 5)),
    "7x1_cin82": (2, 82, 7, 7, 18, (7, 1, 1, 1, 3, 0, 1, 1, 7, 7)),
    "1x7_cin18": (3, 18, 7, 5, 18, (1, 7, 1, 1, 0, 3, 1, 1, 7, 5)),
    "deconv4": (2, 36, 7, 7, 18, (4, 4, 1, 1, 2, 2, 2, 2, 14, 14)),
    "deconv3": (2, 8, 4, 4, 18, (3, 3, 1, 1, 1, 1, 2, 2, 7, 7)),
    "fc": (5, 25088, 1, 1, 512, (1, 1, 1, 1, 0, 0, 1, 1, 1, 1)),
    "deconv4_odd": (2, 36, 5, 6, 18, (4, 4, 1, 1, 2, 2, 2, 2, 9, 11)),
    "deconv3_odd": (3, 8, 4, 3, 18, (3, 3, 1, 1, 1, 1, 2, 2, 7, 5)),
    "co18_bm32": (2, 40, 9, 11, 18, (3, 3, 1, 1, 1, 1, 1, 1, 9, 11)),
    "co33_bm64": (2, 40, 9, 11, 33, (3, 3, 1, 1, 1, 1, 1, 1, 9, 11)),
    "tail_105": (3, 64, 5, 7, 64, (3, 3, 1, 1, 1, 1, 1, 1, 5, 7)),
    "fc_b1": (1, 25088, 1, 1, 512, (1, 1, 1, 1, 0, 0, 1, 1, 1, 1)),
    "fc_b513": (513, 25088, 1, 1, 512, (1, 1, 1, 1, 0, 0, 1, 1, 1, 1)),
}


@pytest.mark.parametrize("bias", [False, True], ids=["nobias", "bias"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", QCONV_CASES)
def test_qconv_kernels_bit_equal_plain(cuda, case, dtype, bias):
    """`quant_act` and `qconv_int8` against their plain versions on the
    card: codes, scales and outputs bit for bit, input one element off."""
    from msml_torch.kernels import qconv

    n, ci, h, w, co, geometry = QCONV_CASES[case]
    gen = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn((n, ci, h, w), generator=gen, device=cuda)
    x[0] *= 5.0
    flat = torch.empty(x.numel() + 1, device=cuda, dtype=dtype)
    x = flat[1:].view(x.shape).copy_(x)  # one element off
    if case.startswith("fc"):
        x = x.view(n, ci)
    cp = qconv.padded_channels(ci)
    xq, sx = qconv.quant_act(x, cp)
    xq_ref, sx_ref = qconv.quant_act_reference(x, cp)
    assert torch.equal(xq, xq_ref) and torch.equal(sx, sx_ref)
    kh, kw = geometry[:2]
    wq = torch.randint(-127, 128, (co, ci, kh, kw), generator=gen,
                       device=cuda).to(torch.int8)
    wp = qconv.pack_weight(wq, cp)
    sw = torch.rand((co,), generator=gen, device=cuda) * 0.01
    b = torch.randn((co,), generator=gen, device=cuda) if bias else None
    y = qconv.qconv_int8(xq, wp, sx, sw, b, geometry, dtype)
    want = qconv.qconv_reference(xq, wp, sx, sw, b, geometry, dtype)
    assert y.dtype == dtype and y.shape == want.shape
    assert torch.equal(y, want)


def test_qconv_kernels_count_and_refuse(cuda):
    from msml_torch.kernels import qconv

    x = torch.randn((2, 64, 5, 5), device=cuda)
    before = (qconv.quant_act.launches, qconv.qconv_int8.launches)
    xq, sx = qconv.quant_act(x, 64)
    wp = qconv.pack_weight(torch.ones((64, 64, 3, 3), dtype=torch.int8,
                                      device=cuda), 64)
    sw = torch.ones((64,), device=cuda)
    qconv.qconv_int8(xq, wp, sx, sw, None, [3, 3, 1, 1, 1, 1, 1, 1, 5, 5],
                     torch.float32)
    assert (qconv.quant_act.launches,
            qconv.qconv_int8.launches) == (before[0] + 1, before[1] + 1)
    with pytest.raises(ValueError, match="16-byte aligned"):
        off = torch.empty(xq.numel() + 1, dtype=torch.int8, device=cuda)
        qconv.qconv_int8(off[1:].view(xq.shape), wp, sx, sw, None,
                         [3, 3, 1, 1, 1, 1, 1, 1, 5, 5], torch.float32)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        qconv.quant_act(x.double(), 64)


# (N, C, H, W, dtype, K of the plan) of each route of `quant_act`: the
# fc's flat row (hw = 1) in one block, rows in clusters of 1 to 16 blocks,
# and a sample over 16 blocks' shared memory on the two-pass route (K = 0)
ACT_ROUTES = {
    "flat_fc": (3, 25088, 1, 1, torch.bfloat16, 1),
    "flat_c82_f32": (3, 82, 1, 1, torch.float32, 1),
    "rows_k1_odd": (3, 18, 13, 11, torch.bfloat16, 1),
    "rows_k1": (2, 64, 28, 28, torch.bfloat16, 1),
    "rows_k2": (2, 128, 28, 28, torch.bfloat16, 2),
    "rows_k4": (2, 64, 56, 56, torch.bfloat16, 4),
    "rows_k8": (2, 82, 56, 56, torch.bfloat16, 8),
    "rows_k16": (2, 64, 112, 112, torch.bfloat16, 16),
    "rows_k16_f32": (2, 64, 112, 112, torch.float32, 16),
    "two_pass_f32": (2, 64, 128, 128, torch.float32, 0),
}


@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "offset"])
@pytest.mark.parametrize("case", ACT_ROUTES)
def test_quant_act_routes_bit_equal_plain(cuda, case, offset):
    """Each route of `quant_act`'s plan, on inputs aligned and one element
    off, with an all-zero sample: codes and scales bit for bit."""
    from msml_torch.kernels import qconv

    n, c, h, w, dtype, k = ACT_ROUTES[case]
    plan = qconv.quant_act_plan(n, c, h * w, dtype.itemsize,
                                qconv.cluster_cap(0, dtype == torch.bfloat16))
    assert plan.k == k
    gen = torch.Generator(device=cuda).manual_seed(4)
    x = torch.randn((n, c, h, w), generator=gen, device=cuda)
    x[0] *= 5.0
    x[1] = 0.0
    flat = torch.empty(x.numel() + offset, device=cuda, dtype=dtype)
    x = flat[offset:].view(x.shape).copy_(x)
    if h == w == 1:
        x = x.view(n, c)
    cp = qconv.padded_channels(c)
    xq, sx = qconv.quant_act(x, cp)
    want_q, want_s = qconv.quant_act_reference(x, cp)
    assert torch.equal(xq, want_q) and torch.equal(sx, want_s)


@pytest.mark.parametrize("case", ["flat_fc", "rows_k16", "two_pass_f32"])
def test_quant_act_graph_nodes(cuda, case):
    """A captured call is one kernel node on the cluster route (no memset,
    no workspace), three on the two-pass route."""
    import ctypes

    from msml_torch.kernels import qconv

    n, c, h, w, dtype, k = ACT_ROUTES[case]
    x = torch.randn((n, c, h, w), device=cuda).to(dtype)
    cp = qconv.padded_channels(c)
    qconv.quant_act(x, cp)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        qconv.quant_act(x, cp)
    count = ctypes.c_size_t(0)
    assert ctypes.CDLL("libcudart.so").cudaGraphGetNodes(
        ctypes.c_void_p(graph.raw_cuda_graph()), None,
        ctypes.byref(count)) == 0
    assert count.value == (1 if k else 3)


def test_quantized_model_rows_are_batch_invariant(cuda):
    """A small CNN's int8 copy on the card: a row's features do not depend
    on its batch-mates (zeros or other images), bit for bit."""
    from msml_torch.core.quantize import quantize_model

    torch.manual_seed(0)
    m = torch.nn.Sequential(
        torch.nn.Conv2d(3, 64, 3, padding=1), torch.nn.ReLU(),
        torch.nn.Conv2d(64, 64, 3, stride=2, padding=1), torch.nn.ReLU(),
        torch.nn.Flatten(), torch.nn.Linear(64 * 8 * 8, 32)).to(cuda)
    x = torch.randn((8, 3, 16, 16), device=cuda)
    q = quantize_model(m, x[:1])
    with torch.no_grad():
        a = q(torch.cat([x[:3], torch.zeros_like(x[3:])]))
        b = q(torch.cat([x[:3], 100.0 * x[3:]]))
    assert torch.equal(a[:3], b[:3])
