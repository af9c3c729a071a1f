"""The port's Triton kernel on the card against its plain version.

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
        pytest.skip("needs a CUDA device (the Triton kernel has no CPU mode)")
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
