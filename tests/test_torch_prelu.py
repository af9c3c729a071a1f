"""The PReLU kernels' plain versions (msml_torch.kernels.prelu) against JAX,
on the CPU.

The reference is the flax module's `jnp.where(x >= 0, x, alpha * x)`
(`msml_tpu/nn/common.py:37`) and its `jax.vjp`, and the Pallas pair of
`benchmarks/negative/prelu_pallas.py` under the TPU interpreter. Inputs
hold exact zeros, where torch's `F.prelu` and JAX disagree on the gradient.
Forward and dx are bit-equal (one rounded product each, in f32 and in
bf16). dalpha is summed in f32 in another order: rtol 1e-5. In bf16 the
port sums the exact f32 products g x, so its dalpha is held against JAX's
f32 dalpha of the same bf16 values (JAX's own bf16 vjp rounds each product
and the sum to 8 bits, 3 % off), and against autograd through the plain
version, which also sums in bf16, at rtol 2e-2. The Triton kernels
themselves run on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from msml_torch.kernels.prelu import (prelu, prelu_bwd, prelu_bwd_reference,
                                      prelu_fwd, prelu_reference)
from msml_torch.nn.common import PReLU

DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}


def _inputs(shape=(3, 6, 5, 7), seed=0):
    """NCHW x with ~20 % exact zeros (and one -0.0), upstream g, slopes."""
    rs = np.random.RandomState(seed)
    x = rs.randn(*shape).astype(np.float32)
    x[rs.rand(*shape) < 0.2] = 0.0
    x.flat[1] = -0.0
    g = rs.randn(*shape).astype(np.float32)
    a = rs.uniform(0.1, 0.4, shape[1]).astype(np.float32)
    return x, g, a


def _jax(x, g, a, jdt):
    """flax PReLU forward and vjp, channels last as the flax module runs."""
    xs = jnp.asarray(x.transpose(0, 2, 3, 1), jdt)
    gs = jnp.asarray(g.transpose(0, 2, 3, 1), jdt)
    y, vjp = jax.vjp(lambda v, s: jnp.where(v >= 0, v, s.astype(v.dtype) * v),
                     xs, jnp.asarray(a))
    dx, da = vjp(gs)
    back = lambda t: np.asarray(t.astype(jnp.float32)).transpose(0, 3, 1, 2)
    return back(y), back(dx), np.asarray(da)


def _torch(x, dt):
    return torch.from_numpy(x).to(dt)


@pytest.mark.parametrize("name", sorted(DTYPES))
def test_plain_versions_match_jax(name):
    tdt, jdt = DTYPES[name]
    x, g, a = _inputs()
    y_want, dx_want, _ = _jax(x, g, a, jdt)
    tx, tg, ta = _torch(x, tdt), _torch(g, tdt), torch.from_numpy(a)
    _, _, da_want = _jax(tx.float().numpy(), tg.float().numpy(), a,
                         jnp.float32)
    y = prelu_fwd(tx, ta)
    dx, da = prelu_bwd(tg, tx, ta)
    assert y.dtype == dx.dtype == tdt and da.dtype == torch.float32
    np.testing.assert_array_equal(y.float().numpy(), y_want)
    np.testing.assert_array_equal(dx.float().numpy(), dx_want)
    np.testing.assert_allclose(da.numpy(), da_want, rtol=1e-5, atol=0)


@pytest.mark.parametrize("name", sorted(DTYPES))
def test_function_matches_reference_autograd(name):
    """The autograd.Function (the wrappers' plain versions on the CPU)
    against autograd through `prelu_reference`, with the same upstream g."""
    tdt, _ = DTYPES[name]
    x, g, a = _inputs(seed=1)
    grads = []
    for fn in (prelu, prelu_reference):
        tx = _torch(x, tdt).requires_grad_()
        ta = torch.from_numpy(a).requires_grad_()
        y = fn(tx, ta)
        y.backward(_torch(g, tdt))
        grads.append((y.detach(), tx.grad, ta.grad))
    (y, dx, da), (y_ref, dx_ref, da_ref) = grads
    torch.testing.assert_close(y, y_ref, rtol=0, atol=0)
    torch.testing.assert_close(dx, dx_ref, rtol=0, atol=0)
    torch.testing.assert_close(da, prelu_bwd_reference(
        _torch(g, tdt), _torch(x, tdt), torch.from_numpy(a))[1],
        rtol=0, atol=0)
    torch.testing.assert_close(da, da_ref, atol=0,
                               rtol=1e-5 if tdt == torch.float32 else 2e-2)


def test_module_gradient_at_zero_is_jax():
    """Fault 1 of the eval slice: `F.prelu` gives alpha * g at x == 0, the
    JAX module gives g. The port's module follows JAX."""
    x = np.array([[0.0, -1.0, 2.0]], np.float32).reshape(1, 1, 1, 3)
    m = PReLU(1)
    tx = torch.from_numpy(x).requires_grad_()
    m(tx).sum().backward()
    _, dx_jax, _ = _jax(x, np.ones_like(x), np.array([0.25], np.float32),
                        jnp.float32)
    np.testing.assert_array_equal(tx.grad.numpy(), dx_jax)
    np.testing.assert_array_equal(tx.grad.numpy().ravel(), [1.0, 0.25, 1.0])
    tx2 = torch.from_numpy(x).requires_grad_()
    F.prelu(tx2, torch.tensor([0.25])).sum().backward()
    assert tx2.grad.numpy().ravel()[0] == 0.25  # torch's own convention


def _pallas_module():
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "benchmarks", "negative",
        "prelu_pallas.py")
    spec = importlib.util.spec_from_file_location("prelu_pallas", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_matches_pallas_kernels_in_interpret_mode():
    """The TPU kernel pair itself (forward, and the backward's dx and its
    dalpha accumulated across the grid), run by the TPU interpreter as
    benchmarks/negative/test_prelu_pallas.py runs it, on NHWC."""
    from jax.experimental.pallas import tpu as pltpu

    pallas = _pallas_module()
    x, g, a = _inputs((4, 8, 8, 16), seed=2)
    xs = jnp.asarray(x.transpose(0, 2, 3, 1))
    gs = jnp.asarray(g.transpose(0, 2, 3, 1))
    with pltpu.force_tpu_interpret_mode():
        y, vjp = jax.vjp(lambda v, s: pallas.prelu(v, s, force_pallas=True),
                         xs, jnp.asarray(a))
        dx, da = vjp(gs)
    tx, ta = torch.from_numpy(x), torch.from_numpy(a)
    dx_t, da_t = prelu_bwd(torch.from_numpy(g), tx, ta)
    nchw = lambda t: np.asarray(t).transpose(0, 3, 1, 2)
    np.testing.assert_array_equal(prelu_fwd(tx, ta).numpy(), nchw(y))
    np.testing.assert_array_equal(dx_t.numpy(), nchw(dx))
    np.testing.assert_allclose(da_t.numpy(), np.asarray(da), rtol=1e-5,
                               atol=0)


def test_wrappers_reject_bad_arguments():
    x = torch.zeros(2, 3, 4, 4)
    with pytest.raises(ValueError):
        prelu_fwd(x, torch.zeros(4))                        # wrong C
    with pytest.raises(ValueError):
        prelu_fwd(x, torch.zeros(3, dtype=torch.float64))   # slope not f32
    with pytest.raises(ValueError):
        prelu_fwd(x.long(), torch.zeros(3))                 # not float
    with pytest.raises(ValueError):
        prelu_bwd(torch.zeros(2, 3, 4, 4, dtype=torch.bfloat16), x,
                  torch.zeros(3))                           # g dtype


def test_two_threads_at_first_launch_decorate_once(monkeypatch, tmp_path):
    """Two threads reach the first launch together (a server's batcher and
    an /embed_batch handler): Triton (a stand-in: a CPU-only machine has
    none) is imported and the four sources are JIT-decorated once, and
    both threads get the same kernels."""
    import sys
    import threading
    import time
    import types

    from msml_torch.kernels import prelu as kprelu

    decorated = []

    def jit(fn):
        decorated.append(fn.__name__)
        time.sleep(0.2)  # the other thread arrives meanwhile
        return types.SimpleNamespace(fn=fn)

    language = types.ModuleType("triton.language")
    triton = types.ModuleType("triton")
    triton.jit, triton.language = jit, language
    monkeypatch.setitem(sys.modules, "triton", triton)
    monkeypatch.setitem(sys.modules, "triton.language", language)
    monkeypatch.setenv("TRITON_CACHE_DIR", str(tmp_path))
    monkeypatch.setattr(kprelu, "_tile", kprelu._tile)
    monkeypatch.setattr(kprelu, "tl", None)
    kprelu._jit_kernels.cache_clear()
    start = threading.Barrier(2)
    got = []

    def first_launch():
        start.wait()
        got.append(kprelu._kernels())

    try:
        threads = [threading.Thread(target=first_launch) for _ in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
            assert not t.is_alive()
        assert sorted(decorated) == sorted(
            ["_tile", "_prelu_fwd_kernel", "_prelu_bwd_kernel",
             "_prelu_reduce_kernel"])
        assert len(got) == 2 and got[0] is got[1]
        assert kprelu._tile.fn.__name__ == "_tile"
    finally:
        kprelu._jit_kernels.cache_clear()
