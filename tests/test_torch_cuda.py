"""The port's Triton kernels on the card against their plain versions.

Marked `cuda`: these need an NVIDIA GPU with Triton and skip elsewhere. Run
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
        pytest.skip("needs a CUDA device (the Triton kernels have no CPU "
                    "mode)")
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
