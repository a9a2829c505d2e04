"""The plain version of the attention backward kernels
(``flash_attention_bwd_plain``: FlashAttention-2's backward on whole
tensors) against ``torch.autograd`` through ``attention_plain`` and against
``jax.grad`` of ``prometheus_tpu.ops.attention._xla_attention``, the JAX
package's CPU path, on the CPU in fp32 at D = 8, 72 and 512.

Tolerance: ``max|a - b| / max|b| <= 1e-5`` per gradient (fp32 products
summed in another order; the recomputed probabilities ``exp(s - lse)``
carry one more rounding than the softmax).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prometheus_tpu.ops.attention import _xla_attention
from prometheus_torch.ops.attention import (FlashAttention, attention_lse_plain,
                                            attention_plain,
                                            flash_attention_bwd_plain)
from test_torch_layers_vae import scaled_err

TOL = 1e-5
SHAPES = [(2, 128, 3, 8), (1, 256, 2, 72), (1, 128, 1, 512)]


def inputs(rng, shape):
    return [rng.normal(size=shape).astype(np.float32) for _ in range(4)]


@pytest.mark.parametrize("shape", SHAPES)
def test_bwd_plain_matches_autograd_and_jax(rng, shape):
    q, k, v, do = inputs(rng, shape)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = attention_plain(tq, tk, tv)
    out.backward(torch.from_numpy(do))
    with torch.no_grad():
        got = flash_attention_bwd_plain(
            tq, tk, tv, out, attention_lse_plain(tq, tk), torch.from_numpy(do))
    scale = shape[-1] ** -0.5
    with jax.default_matmul_precision("float32"):
        _, vjp = jax.vjp(lambda a, b, c: _xla_attention(a, b, c, scale),
                         jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
        ref = vjp(jnp.asarray(do))
    for name, g, a, r in zip("qkv", got, (tq.grad, tk.grad, tv.grad), ref):
        assert g.shape == shape
        assert scaled_err(g.numpy(), a.numpy()) <= TOL, name
        assert scaled_err(g.numpy(), np.asarray(r)) <= TOL, name


def test_flash_function_on_cpu_is_autograd_of_the_plain_path(rng):
    """On CPU tensors ``FlashAttention`` runs the plain forward (with the
    log-sum-exp) and the plain backward; its gradients are autograd's."""
    shape = (1, 128, 2, 16)
    q, k, v, do = inputs(rng, shape)
    a = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    b = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = FlashAttention.apply(*a)
    out.backward(torch.from_numpy(do))
    ref = attention_plain(*b)
    ref.backward(torch.from_numpy(do))
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    for x, y in zip(a, b):
        assert scaled_err(x.grad.numpy(), y.grad.numpy()) <= TOL
