"""K5 of the port, ``takum_matmul_ad`` (a ``torch.autograd.Function``), against
``jax.vjp`` / ``jax.grad`` of ``repro.kernels.takum_matmul.takum_matmul_ad``.

Here on the CPU both directions run their plain versions: the forward is
``takum_matmul_plain`` (K3's), the backward ``takum_matmul_t_plain`` (the
transposed K3's, ``dx = g @ decode(w).T``); ``repro``'s run its Pallas
kernel in interpret mode.  ``tests/test_torch_gpu.py`` holds the CUDA
kernels against these plain versions on the card.

  * Exact sums: x and the cotangent g are multiples of 2^-4 in [-4, 4], the
    weight is encoded from values every flat format holds exactly, and K, N
    <= 64, so every f32 partial sum is exact in any order: the output and dx
    must equal ``repro``'s bit for bit, for every flat format and each
    decode codec of the transposed K3 (the codecs decode to the same values).
  * Random inputs: |port - repro| <= 1e-6 * (|g| @ |decode(w)|.T) for dx,
    and 1e-6 * (|x| @ |decode(w)|) for the output: the two sum in another
    order (ROADMAP R1).
  * As in ``repro``: dx in x's dtype (bf16 x, bf16 dx), no gradient for the
    packed weight, and a block-scaled format refused with "block-scaled".
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.takum_matmul import takum_matmul_ad as j_matmul_ad
from repro_torch.kernels import ops
from repro_torch.kernels.takum_matmul import (takum_matmul, takum_matmul_ad, takum_matmul_t,
                                              takum_matmul_t_plain)

FMTS = ("t8", "t16", "e4m3", "e5m2", "bf16")
IMPLS = ("bits", "lut")
#: values every flat format holds exactly
EXACT_W = np.array([0, 0.25, 0.5, 0.75, 1, 1.5, 2], np.float32)
#: x [M, K] @ w [K, N]: K != N, so a transposition mistake cannot pass
M, K, N = 5, 40, 64


def _exact(shape, seed, values=None):
    """Multiples of 2^-4 in [-4, 4], or signed draws from ``values``."""
    rng = np.random.default_rng(seed)
    if values is None:
        return (rng.integers(-64, 65, shape) / 16).astype(np.float32)
    return (rng.choice(values, shape) * rng.choice([-1, 1], shape)).astype(np.float32)


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


@functools.lru_cache(maxsize=None)
def _case(fmt, kind):
    """(x, w_bits, g, repro's output, repro's dx) as numpy, one vjp of
    ``repro``'s takum_matmul_ad per format and kind ("exact" or "random")."""
    if kind == "exact":
        x, w, g = _exact((M, K), 1), _exact((K, N), 2, EXACT_W), _exact((M, N), 3)
    else:
        x, w, g = _rand((M, K), 4), _rand((K, N), 5, K ** -0.5), _rand((M, N), 6)
    wb = jops.encode(jnp.asarray(w), fmt)
    y, vjp = jax.vjp(lambda a: j_matmul_ad(a, wb, fmt), jnp.asarray(x))
    (dx,) = vjp(jnp.asarray(g))
    return x, np.array(wb), g, np.asarray(y), np.asarray(dx)


def _port(x, wb, g, fmt):
    """The port's output and dx for cotangent g."""
    xt = _t(x).requires_grad_()
    y = takum_matmul_ad(xt, _t(wb), fmt)
    y.backward(_t(g))
    return y.detach(), xt.grad


def test_grads_x_only_twin():
    """Twin of tests/test_kernels.py::test_matmul_custom_vjp_grads_x_only:
    the gradient of sum(takum_matmul_ad(x, w, 8)) is every row of decode(w)
    summed over N, and the forward equals takum_matmul."""
    x = _rand((16, 32), 0)
    wb = _t(jops.encode(jnp.asarray(_rand((32, 8), 7, 0.3)), "t8"))
    xt = _t(x).requires_grad_()
    takum_matmul_ad(xt, wb, 8).sum().backward()
    w = np.asarray(jref.codec_decode_ref(jnp.asarray(wb.numpy()), 8))
    np.testing.assert_allclose(xt.grad.numpy(), np.tile(w.sum(-1), (16, 1)), rtol=1e-5,
                               atol=1e-5)
    assert torch.equal(takum_matmul_ad(_t(x), wb, 8), takum_matmul(_t(x), wb, 8))
    jgrad = jax.grad(lambda a: j_matmul_ad(a, jnp.asarray(wb.numpy()), 8).sum())(jnp.asarray(x))
    limit = 1e-6 * np.tile(np.abs(w).sum(-1), (16, 1))
    assert np.all(np.abs(xt.grad.numpy() - np.asarray(jgrad)) <= limit)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("fmt", FMTS)
def test_exact_sums_equal_repro_bit_for_bit(fmt, impl):
    x, wb, g, y_want, dx_want = _case(fmt, "exact")
    y, dx = _port(x, wb, g, fmt)
    assert np.array_equal(y.numpy(), y_want)
    assert dx.dtype == torch.float32 and np.array_equal(dx.numpy(), dx_want)
    # the transposed K3 under each codec, and the f64 plain path
    assert np.array_equal(takum_matmul_t(_t(g), _t(wb), fmt, impl).numpy(), dx_want)
    with ops.plain_path(torch.float64):
        _, dx64 = _port(x, wb, g, fmt)
    assert np.array_equal(dx64.numpy(), dx_want)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("fmt", FMTS)
def test_random_within_order_tolerance(fmt, impl):
    x, wb, g, y_want, dx_want = _case(fmt, "random")
    y, dx = _port(x, wb, g, fmt)
    w = np.asarray(jref.codec_decode_ref(jnp.asarray(wb), fmt))
    assert np.all(np.abs(y.numpy() - y_want) <= 1e-6 * (np.abs(x) @ np.abs(w)))
    limit = 1e-6 * (np.abs(g) @ np.abs(w).T)
    assert np.all(np.abs(dx.numpy() - dx_want) <= limit)
    got = takum_matmul_t(_t(g), _t(wb), fmt, impl).numpy()
    assert np.all(np.abs(got - dx_want) <= limit)


@pytest.mark.parametrize("fmt", ("t8", "t16"))
def test_bf16_x_gives_bf16_grad(fmt):
    x, wb, g, _, _ = _case(fmt, "exact")
    xb = _t(x).to(torch.bfloat16).requires_grad_()
    y = takum_matmul_ad(xb, _t(wb), fmt)
    assert y.dtype == torch.float32
    y.backward(_t(g))
    assert xb.grad.dtype == torch.bfloat16
    _, vjp = jax.vjp(lambda a: j_matmul_ad(a, jnp.asarray(wb), fmt),
                     jnp.asarray(x, jnp.bfloat16))
    (want,) = vjp(jnp.asarray(g))
    assert want.dtype == jnp.bfloat16
    assert np.array_equal(xb.grad.float().numpy(), np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("fmt", ("mxe4m3", "mxe5m2", "mxt8"))
def test_block_scaled_refused_like_repro(fmt):
    x, wb = np.zeros((8, 32), np.float32), np.zeros((32, 33), np.uint8)
    with pytest.raises(ValueError, match="block-scaled"):
        j_matmul_ad(jnp.asarray(x), jnp.asarray(wb), fmt)
    with pytest.raises(ValueError, match="block-scaled"):
        takum_matmul_ad(_t(x).requires_grad_(), _t(wb), fmt)
    with pytest.raises(ValueError, match="block-scaled"):
        takum_matmul_t(torch.zeros(8, 33), _t(wb), fmt)


def test_packed_weight_gets_no_grad_and_cpu_launches_nothing():
    x, wb, g, _, dx_want = _case("t8", "exact")
    w = _t(wb)
    ops.reset_launch_counts()
    xt = _t(x).requires_grad_()
    y = takum_matmul_ad(xt, w, "t8")
    (dx,) = torch.autograd.grad(y, [xt], _t(g))
    assert np.array_equal(dx.numpy(), dx_want)
    assert not w.requires_grad and w.grad is None
    assert not any(ops.launch_counts().values())
    # the pieces refuse what the kernel does not take
    with pytest.raises(ValueError):
        takum_matmul_t(torch.zeros(2, 7), w, "t8")
    with pytest.raises(TypeError):
        takum_matmul_t(torch.zeros(2, N, dtype=torch.float64), w, "t8")
    with pytest.raises(TypeError):
        takum_matmul_t(torch.zeros(2, N), w.to(torch.int16), "t16")
    assert torch.equal(takum_matmul_t(_t(g), w, "t8"), takum_matmul_t_plain(_t(g), w, "t8"))
