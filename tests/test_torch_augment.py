"""The augmentation kernel's plain version (msml_torch.kernels.augment)
against the JAX stage it ports, on the CPU.

Three holds: the jnp functions with their `jax.random` draws recomputed and
injected as r0..r5; the Pallas kernel under the TPU interpreter, whose PRNG
is stubbed to zeros; and the property tests of tests/test_device_augment.py.
The CUDA kernel itself runs only on the card (tests/test_torch_cuda.py,
chip_smoke.py); tests/test_torch_augment_cluster.py replays its blocking.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msml_tpu.kernels.augment import (device_augment_batch,
                                      device_gauss_light,
                                      device_random_block)
from msml_torch.kernels.augment import augment_batch, augment_batch_reference

RTOL = 1e-6  # relight: exp and division in another library


def _img(shape, seed=0, lo=0.0, hi=1.0):
    return np.random.RandomState(seed).uniform(lo, hi, shape).astype(
        np.float32)


def _block_draws(rng, b, lo, hi):
    """r0..r2 as device_random_block draws them (augment.py:70-75): r0
    picks the same ratio, r1/r2 are its uniforms."""
    k_r, k_x, k_y, _ = jax.random.split(rng, 4)
    ratio = np.asarray(jax.random.randint(k_r, (b,), lo, hi))
    r0 = (ratio - lo + 0.5) / (hi - lo)
    return np.stack([r0, np.asarray(jax.random.uniform(k_x, (b,))),
                     np.asarray(jax.random.uniform(k_y, (b,)))], 1)


def _block_noise(rng, shape):
    return np.array(jax.random.normal(jax.random.split(rng, 4)[3], shape))


def _light_draws(rng, b):
    """r3..r5 as device_gauss_light draws them (augment.py:51-54)."""
    return np.stack([np.asarray(jax.random.uniform(k, (b,)))
                     for k in jax.random.split(rng, 3)], 1)


def _port(img, draws, noise=None, **kw):
    t = augment_batch(torch.from_numpy(img),
                      torch.from_numpy(draws.astype(np.float32)),
                      None if noise is None else torch.from_numpy(noise),
                      **kw)
    return t.numpy().transpose(0, 2, 3, 1)  # NCHW -> NHWC


@pytest.mark.parametrize("c", [3, 1])
@pytest.mark.parametrize("fill", ["black", "white", "gauss"])
def test_block_matches_jnp(fill, c):
    img = _img((4, 112, 112, c))
    rng = jax.random.PRNGKey(7)
    want = np.asarray(device_random_block(jnp.asarray(img), rng, 20, 51,
                                          fill))
    draws = np.concatenate([_block_draws(rng, 4, 20, 51),
                            np.zeros((4, 3))], 1)
    noise = _block_noise(rng, img.shape) if fill == "gauss" else None
    got = _port(img, draws, noise, lo=20, hi=51, fill=fill, use_norm=False)
    np.testing.assert_array_equal(got, want)


def test_relight_matches_jnp():
    img = _img((4, 112, 112, 3), lo=0.2)
    rng = jax.random.PRNGKey(8)
    want = np.asarray(device_gauss_light(jnp.asarray(img), rng))
    draws = np.concatenate([np.zeros((4, 3)), _light_draws(rng, 4)], 1)
    got = _port(img, draws, relight=True, use_norm=False)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)


@pytest.mark.parametrize("fill", ["black", "gauss"])
def test_fused_stage_matches_device_augment_batch(fill):
    """Block -> relight -> normalize, as device_augment_batch splits its
    key (augment.py:100-110)."""
    img = _img((3, 112, 112, 3), seed=3)
    rng = jax.random.PRNGKey(9)
    want = np.asarray(device_augment_batch(
        jnp.asarray(img), rng, lo=30, hi=41, fill=fill, use_norm=True,
        relight=True))
    k1, rest = jax.random.split(rng)
    k2, _ = jax.random.split(rest)
    draws = np.concatenate([_block_draws(k1, 3, 30, 41),
                            _light_draws(k2, 3)], 1)
    noise = _block_noise(k1, img.shape) if fill == "gauss" else None
    got = _port(img, draws, noise, lo=30, hi=41, fill=fill, relight=True,
                use_norm=True)
    # normalized values cross zero: an absolute floor of the same size
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=2 * RTOL)


@pytest.mark.parametrize("fill", ["black", "white", "gauss"])
@pytest.mark.parametrize("relight", [False, True])
def test_matches_pallas_interpret_zero_draws(fill, relight):
    """The Pallas kernel under the TPU interpreter, whose PRNG returns zeros
    (tests/test_device_augment.py:85-87): r0..r5 = 0, and its gauss fill is
    then the constant (0 - 0.5) * 3.46 (augment.py:164-166)."""
    from jax.experimental.pallas import tpu as pltpu
    from msml_tpu.kernels.augment import pallas_augment_batch

    img = _img((2, 112, 112, 3), seed=4)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(pallas_augment_batch(
            jnp.asarray(img), seed=1, lo=40, hi=41, fill=fill,
            use_norm=True, relight=relight))
    noise = np.full(img.shape, (0.0 - 0.5) * 3.46, np.float32)
    got = _port(img, np.zeros((2, 6)), noise, lo=40, hi=41, fill=fill,
                relight=relight, use_norm=True)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=2 * RTOL)


# -------------------------- properties (tests/test_device_augment.py:13-67)
def _draws(b, seed=0):
    return torch.from_numpy(_img((b, 6), seed=seed))


def test_block_area_and_fill():
    img = torch.full((8, 112, 112, 3), 0.8)
    out = augment_batch(img, _draws(8), lo=40, hi=41, fill="black",
                        use_norm=False)
    area = (out == 0).all(1).sum((1, 2))
    want = int(np.floor(np.sqrt(0.40) * 112)) ** 2
    assert (area == want).all(), area
    out_w = augment_batch(img, _draws(8), lo=40, hi=41, fill="white",
                          use_norm=False)
    assert ((out_w == 1.0).all(1).sum((1, 2)) == want).all()


def test_zero_ratio_identity():
    img = torch.from_numpy(_img((2, 112, 112, 3), seed=1))
    out = augment_batch(img, _draws(2), lo=0, hi=1, fill="black",
                        use_norm=False)
    np.testing.assert_array_equal(out.permute(0, 2, 3, 1).numpy(),
                                  img.numpy())


def test_relight_range_and_max():
    img = torch.from_numpy(_img((4, 112, 112, 3), seed=2, lo=0.2))
    out = augment_batch(img, _draws(4, seed=2), relight=True, use_norm=False)
    np.testing.assert_allclose(out.amax(dim=(1, 2, 3)).numpy(), 1.0,
                               rtol=1e-5)
    assert float(out.min()) >= 0.0


def test_normalize_only_and_layout():
    img = torch.from_numpy(_img((2, 8, 8, 3), seed=3))
    out = augment_batch(img, _draws(2), use_norm=True)
    want = (img.numpy() - 0.5) / 0.5
    np.testing.assert_allclose(out.numpy(), want.transpose(0, 3, 1, 2),
                               rtol=1e-6)


def test_area_distribution_matches_host_random_block():
    """Occluded-area distribution over many draws matches the host
    RandomBlock (same ratio law)."""
    from PIL import Image
    from msml_tpu.data.rand_occ import RandomBlock

    n = 64
    img = torch.full((n, 112, 112, 3), 0.5)
    out = augment_batch(img, torch.rand((n, 6),
                                        generator=torch.Generator()
                                        .manual_seed(4)),
                        lo=20, hi=51, fill="black", use_norm=False)
    dev_frac = (out == 0).all(1).float().mean((1, 2)).numpy()

    host = RandomBlock(20, 51, "black")
    r = np.random.RandomState(0)
    pil = Image.fromarray(np.full((112, 112, 3), 128, np.uint8))
    host_frac = [(np.asarray(host(pil, r)) == 0).all(-1).mean()
                 for _ in range(n)]
    assert abs(dev_frac.mean() - np.mean(host_frac)) < 0.05


def test_rejects_bad_inputs():
    img = torch.zeros((2, 8, 8, 3))
    with pytest.raises(ValueError):
        augment_batch(img, torch.zeros((2, 5)))
    with pytest.raises(ValueError):
        augment_batch(img, torch.zeros((2, 6)), lo=10, hi=11, fill="gauss")
    with pytest.raises(ValueError):
        augment_batch(img.double(), torch.zeros((2, 6)))
    with pytest.raises(ValueError):
        augment_batch(img, torch.zeros((2, 6)), fill="grey")


def test_cpu_tensor_takes_plain_version_and_counts_no_launch():
    before = augment_batch.launches
    img = torch.from_numpy(_img((2, 16, 16, 1), seed=5))
    draws = _draws(2, seed=5)
    kw = dict(lo=10, hi=31, fill="white", relight=True, use_norm=True)
    np.testing.assert_array_equal(augment_batch(img, draws, **kw).numpy(),
                                  augment_batch_reference(img, draws,
                                                          **kw).numpy())
    assert augment_batch.launches == before
