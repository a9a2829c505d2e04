"""Port parity for stage-1 training's loss: the scale-and-shift-invariant
depth loss and ``GSDecoderSystem.loss`` with its gradient for every
parameter, against the JAX package on the CPU in fp32.

The system runs the small widths (DiT hidden 32, depth 1, 4 heads; VAE ch
32, ch_mult (1, 2)), 64x64 images, 2 input and 2 novel views, batch 1, with
random weights in the JAX tree's shapes loaded through
``weights.load_jax_params`` and the same encoder noise
(``jax.random.normal(key, mean.shape)``, which JAX draws for the rgb and the
depth pass alike). JAX renders with ``backend='xla'`` (its CPU path), the
port through kernel B's and kernel C's plain versions.

Tolerances: the depth loss and its gradient ``rtol 1e-5`` and ``scaled_err
<= 1e-5`` against JAX in float64 (see the test). The system's loss and
metrics ``rtol 1e-3``, the bound of the renders' parity (the
compositor's early transmittance stop moves pixels by up to 1e-4, and a
gaussian that moves by rounding can cross a pixel's alpha cutoff); measured
3e-7. Every gradient ``max|a - b| <= 1e-3 * max|b|``, measured up to 8.6e-5:
the decoder's gradients sum per-pixel render differences over 2 x 64 x 64
pixels and 14 channels. The EMANorm magnitudes ``rtol 1e-4``. Leaves of the
frozen encoder get no gradient in either package.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prometheus_tpu.models.gs_decoder import GSDecoderModel as JaxGSDecoder
from prometheus_tpu.systems.depth_loss import \
    scale_and_shift_invariant_loss as jax_ssi
from prometheus_tpu.systems.gs_decoder_system import \
    GSDecoderSystem as JaxSystem
from prometheus_tpu.utils import get_random_cameras as jax_random_cameras
from prometheus_torch.models import GSDecoderModel
from prometheus_torch.systems import (GSDecoderSystem,
                                      scale_and_shift_invariant_loss)
from prometheus_torch.weights import _flatten, _jax_name, load_jax_params
from test_torch_layers_vae import random_params, scaled_err

SMALL = dict(dit_hidden_size=32, dit_depth=1, dit_num_heads=4, vae_ch=32,
             vae_ch_mult=(1, 2), max_num_images=4)
IMG, N_IN, N_NV = 64, 2, 2


def test_ssi_depth_loss_and_grad(rng):
    """Held in float64 (JAX under ``jax.enable_x64``) to 1e-5, and the
    port's fp32 against JAX's float64 to 1e-5 as well: the closed-form
    solve cancels in its 2x2 determinant, and JAX's own fp32 gradient sits
    6e-5 of max|grad| from its float64 one on these inputs (the port's
    fp32 4.5e-6), so fp32 against fp32 would measure JAX's rounding."""
    # disparities of a rendered scene at 1-20 units from the camera
    pred = rng.uniform(0.05, 1.0, size=(3, 16, 16))
    target = rng.uniform(0.0, 1.0, size=(3, 16, 16))
    mask = (rng.uniform(size=(3, 16, 16)) > 0.3).astype(np.float64)
    mask[2] = 0.0                 # a singular image: the safe divisions
    with jax.enable_x64(True):
        val, grad = jax.value_and_grad(jax_ssi)(
            jnp.asarray(pred), jnp.asarray(target), jnp.asarray(mask))
        val, grad = float(val), np.asarray(grad)
    for dtype in (torch.float64, torch.float32):
        tp = torch.tensor(pred, dtype=dtype, requires_grad=True)
        loss = scale_and_shift_invariant_loss(
            tp, torch.tensor(target, dtype=dtype),
            torch.tensor(mask, dtype=dtype))
        loss.backward()
        np.testing.assert_allclose(float(loss.detach()), val, rtol=1e-5)
        assert np.isfinite(tp.grad.numpy()).all()
        assert scaled_err(tp.grad.numpy(), grad) <= 1e-5, dtype


@pytest.fixture(scope="module")
def system_both():
    return run_both()


def run_both():
    """The JAX loss, metrics, EMANorm state and gradients, and the port's
    after one ``loss.backward()``, on the same weights, batch and noise."""
    rng = np.random.default_rng(11)
    jmod = JaxGSDecoder(dtype=jnp.float32, **SMALL)
    variables = random_params(jmod, rng, jnp.zeros((1, 1, 3, IMG, IMG)),
                              jnp.zeros((1, N_IN, 14, IMG // 2, IMG // 2)),
                              method=JaxGSDecoder.init_everything)
    n = N_IN + N_NV
    cams = np.asarray(jax_random_cameras(jax.random.PRNGKey(2), n,
                                         size=IMG))[None]
    batch = {
        "images_mv": rng.uniform(-1, 1, size=(1, n, 3, IMG, IMG)),
        "cameras_mv": cams,
        "depths_mv": rng.uniform(0.05, 1.0, size=(1, n, 1, IMG, IMG)),
    }
    batch = {k: np.asarray(v, np.float32) for k, v in batch.items()}
    key = jax.random.PRNGKey(4)
    noise = np.asarray(jax.random.normal(key, (N_IN, 4, IMG // 2, IMG // 2)))

    jsys = JaxSystem(model=jmod, render_size=IMG)
    params = variables["params"]
    state = {k: v for k, v in variables.items() if k != "params"}

    def loss_fn(p):
        return jsys.loss(p, state, {k: jnp.asarray(v) for k, v in
                                    batch.items()}, key,
                         num_input_views=N_IN, render_size=IMG)

    with jax.default_matmul_precision("float32"):
        (jloss, (jmetrics, jstate)), jgrads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(params)

    mod = GSDecoderModel(**SMALL)
    assert load_jax_params(mod, variables) == []
    system = GSDecoderSystem(mod, render_size=IMG)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tb["encode_noise"] = torch.from_numpy(noise.copy()).reshape(
        1, N_IN, 4, IMG // 2, IMG // 2)
    loss, metrics = system.loss(tb, num_input_views=N_IN, render_size=IMG)
    loss.backward()
    return (dict(loss=jloss, metrics=jmetrics, state=jstate, grads=jgrads,
                 system=jsys, variables=variables, batch=batch, key=key),
            dict(loss=loss, metrics=metrics, model=mod, batch=tb))


def test_system_loss_and_metrics(system_both):
    ref, out = system_both
    np.testing.assert_allclose(float(out["loss"].detach()),
                               float(ref["loss"]), rtol=1e-3)
    assert set(out["metrics"]) == set(ref["metrics"]) == {
        "psnr_mv", "loss_mv_image_mse", "loss_mv_depth"}
    for k, v in ref["metrics"].items():
        np.testing.assert_allclose(float(out["metrics"][k]), float(v),
                                   rtol=1e-3, err_msg=k)
    # the EMANorm magnitudes after the training forward
    flat = dict(_flatten(ref["state"]["batch_stats"]))
    assert flat
    buffers = dict(out["model"].named_buffers())
    for path, v in flat.items():
        np.testing.assert_allclose(float(buffers[_jax_name(path)[0]]),
                                   float(v), rtol=1e-4)


def test_system_inference(system_both):
    """``inference`` on the input views of the batch, with the weights and
    EMANorm state before training, against the JAX system given the same
    key (the port takes that key's normal draw as its noise). Gaussians
    ``scaled_err <= 1e-4`` (one decode, no training step); renders mean
    absolute error ``<= 1e-3`` and max ``<= 5e-2``, as the slice's renders
    (a gaussian that moves by rounding can cross a pixel's alpha cutoff)."""
    ref, out = system_both
    b, jsys = ref["batch"], ref["system"]
    views = lambda a: (a[:, :N_IN], a[:, N_IN:])
    (img_in, _), (dep_in, _) = views(b["images_mv"]), views(b["depths_mv"])
    cam_in, cam_nv = views(b["cameras_mv"])
    with jax.default_matmul_precision("float32"):
        want = jax.jit(lambda v, i, d, c, n: jsys.inference(
            v, i, d, c, n, key=ref["key"], render_size=IMG))(
                ref["variables"], img_in, dep_in, cam_in, cam_nv)
    mod = GSDecoderModel(**SMALL)
    assert load_jax_params(mod, ref["variables"]) == []
    got = GSDecoderSystem(mod, render_size=IMG).inference(
        *(torch.from_numpy(a) for a in (img_in, dep_in, cam_in, cam_nv)),
        noise=out["batch"]["encode_noise"])
    for a, r in zip(got["gaussians"], want["gaussians"]):
        assert scaled_err(a.numpy(), np.asarray(r)) <= 1e-4
    for name in ("images_nv_pred", "masks_nv_pred"):
        err = np.abs(got[name].numpy() - np.asarray(want[name]))
        assert err.shape == (1, N_NV, 3 if "images" in name else 1, IMG, IMG)
        assert float(err.mean()) <= 1e-3 and float(err.max()) <= 5e-2, name


@pytest.mark.parametrize("part", ["vae/decoder", "vae/post_quant_conv",
                                  "cross_view_dit", "vae/encoder"])
def test_system_gradients(system_both, part):
    """Each leaf ``max|a - b| <= 1e-3 * max|b|``. A leaf whose gradient is
    zero in exact arithmetic (the attention key bias, which softmax ignores;
    conv biases that a GroupNorm of one channel per group removes) is held
    to 1e-3 of 1e-3 of the model's largest gradient instead of to its own
    rounding noise (every other leaf's max|grad| is above 1e-2 of it)."""
    ref, out = system_both
    params = dict(out["model"].named_parameters())
    floor = 1e-3 * max(float(np.abs(np.asarray(g)).max())
                       for _, g in _flatten(ref["grads"]))
    checked = 0
    for path, g in _flatten(ref["grads"]):
        if not "/".join(path).startswith(part):
            continue
        name, is_kernel = _jax_name(path)
        got = params[name].grad
        g = np.asarray(g)
        if part == "vae/encoder":        # frozen: no gradient in either
            assert got is None and np.abs(g).max() == 0.0, name
            checked += 1
            continue
        got = got.numpy()
        if is_kernel:
            got = got.T if got.ndim == 2 else got.transpose(2, 3, 1, 0)
        scale = max(float(np.abs(g).max()), floor)
        assert np.abs(got - g).max() <= 1e-3 * scale, name
        checked += 1
    assert checked > 0
