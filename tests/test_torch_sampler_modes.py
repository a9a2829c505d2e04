"""Port parity for the sampler's modes against the JAX package on the CPU,
in fp32: the schedules, every guidance type, DPM-Solver++(2M), guidance on
an interval, discrete timesteps, the sigma adjustment, view-mask pinning,
the VAE encoder, ``render_to_latent`` and 3D mode.

The models are the tiny MV-LDM of ``test_torch_sampler`` (random weights in
both packages) and the small GS decoder of ``pipeline.SMALL_GSDECODER``;
JAX's ``MVLDMSystem.sample`` draws its start from a key, and the port is
given that draw.

Tolerances: schedule tables bit-equal, coefficient functions ``rtol
1e-6``, the DPM-Solver++ step ``scaled_err <= 1e-6``; one sampler step
``scaled_err <= 1e-4`` (``TOL``); two or more steps ``1e-3``: each later
U-Net call starts from the earlier step's fp32 rounding, which 7.5x
guidance and random weights amplify about tenfold (as in
``test_torch_sampler``). One 3D step's render from the same x0 is held at
the slice tests' render limits (mean absolute error ``<= 1e-3``, max ``<=
5e-2``) and ``render_to_latent`` at ``TOL``; the whole 3D-mode loop runs
through ``generate`` in ``test_torch_refiners``.

The guidance types run JAX's loop body (``_guided_output``, the x0
readout, the Euler step) as one jitted step per type; every other case
runs JAX's ``sample``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prometheus_tpu.models.gs_decoder import GSDecoderModel as JaxGSDecoder
from prometheus_tpu.models.mv_ldm import MVLDMModel as JaxMVLDM
from prometheus_tpu.ops import schedulers as js
from prometheus_tpu.ops.gaussian import render_gaussians as jax_render
from prometheus_tpu.systems.mv_ldm_system import MVLDMSystem as JaxSystem
from prometheus_torch.models import GSDecoderModel
from prometheus_torch.ops import schedulers as ts
from prometheus_torch.ops.gaussian import convert_gaussians, render_gaussians
from prometheus_torch.pipeline import SMALL_GSDECODER
from prometheus_torch.systems import MVLDMSystem
from prometheus_torch.utils.rays import raymap
from prometheus_torch.weights import load_jax_params
from test_torch_layers_vae import TOL, random_params, scaled_err
from test_torch_sampler import tiny_mvldm  # noqa: F401  (fixture)

GUIDANCE = ["none", "text", "pose", "joint", "hybrid"]


@pytest.fixture(scope="module")
def one_thread():
    """One PyTorch thread for a module of tiny shapes: the test run's
    workers share the machine's cores, and idle intra-op threads of six
    processes at once slow every worker down."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


pytestmark = pytest.mark.usefixtures("one_thread")
SCHEDULES = [("vprediction", {}), ("eprediction", {}), ("edm", {}),
             ("edm", dict(high_noise=True)), ("edm", dict(sigma_data=0.5))]


def pair(kind, kw):
    return js.make_schedule(kind, **kw), ts.make_schedule(kind, **kw)


@pytest.mark.parametrize("kind,kw", SCHEDULES)
def test_schedule_matches_jax(kind, kw):
    jsch, tsch = pair(kind, kw)
    for f in ("kind", "prediction_type", "sigma_min", "sigma_max", "rho",
              "sigma_schedule", "p_mean", "p_std", "sigma_data"):
        assert getattr(tsch, f) == getattr(jsch, f), f
    if jsch.train_sigmas is None:
        assert tsch.train_sigmas is None
    else:
        assert tsch.train_sigmas.dtype == np.float32
        np.testing.assert_array_equal(tsch.train_sigmas,
                                      np.asarray(jsch.train_sigmas))
    for n in (1, 4, 50):
        for ladder in ("default", "karras"):
            np.testing.assert_array_equal(
                tsch.inference_sigmas(n, ladder=ladder).numpy(),
                np.asarray(jsch.inference_sigmas(n, ladder=ladder)))
    s = np.array([0.002, 0.03, 0.7, 14.6, 80.0, 9000.0], np.float32)
    st = torch.from_numpy(s)
    for name in ("c_skip", "c_out", "c_in", "c_noise", "loss_weight"):
        np.testing.assert_allclose(getattr(tsch, name)(st).numpy(),
                                   np.asarray(getattr(jsch, name)(s)),
                                   rtol=1e-6, err_msg=name)


def test_unknown_schedule_raises():
    with pytest.raises(ValueError, match="unknown schedule"):
        ts.make_schedule("ddim")


@pytest.mark.parametrize("has_prev", [False, True])
@pytest.mark.parametrize("sigma_next", [0.0, 0.4])
def test_dpmpp_2m_step_matches_jax(rng, has_prev, sigma_next):
    jsch, tsch = pair("vprediction", {})
    x, x0, x0p = (rng.normal(size=(1, 2, 8, 4, 4)).astype(np.float32)
                  for _ in range(3))
    f = np.float32
    ref = jsch.dpmpp_2m_step(x, x0, x0p, f(3.1), f(1.7), f(sigma_next),
                             f(has_prev))
    out = tsch.dpmpp_2m_step(*map(torch.from_numpy, (x, x0, x0p)),
                             torch.tensor(3.1), torch.tensor(1.7),
                             torch.tensor(sigma_next), has_prev)
    # held to 1e-6 of the largest value: XLA's float32 log is not correctly
    # rounded (log(3.1) is one ulp off), and the second-order step to
    # sigma 0 multiplies that ulp by 1 / (2 r) ~ 38 in single elements
    assert scaled_err(out.numpy(), ref) <= 1e-6


def embeddings(seed=2):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=(1, 77, 64)).astype(np.float32)
                 for _ in range(2))


def sample_both(tiny, steps, jsys_kw=None, key=3, **kw):
    """JAX ``MVLDMSystem.sample`` from a key, and the port's ``sample``
    from that key's draw, same weights, cameras and embeddings."""
    jmodel, params, model, cams = tiny
    temb, uemb = embeddings()
    jsys = JaxSystem(model=jmodel, **(jsys_kw or {}))
    k = jax.random.PRNGKey(key)
    jkw = {n: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
           for n, v in kw.items()}
    with jax.default_matmul_precision("float32"):
        ref = jsys.sample(params, k, jnp.asarray(cams), jnp.asarray(temb),
                          jnp.asarray(uemb), num_inference_steps=steps,
                          latent_hw=8, **jkw)
    noise = np.asarray(jax.random.normal(k, (1, cams.shape[1], 8, 8, 8)))
    tsys = MVLDMSystem(model=model, **(jsys_kw or {}))
    tkw = {n: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
           for n, v in kw.items()}
    out = tsys.sample(torch.from_numpy(cams.copy()), torch.from_numpy(temb),
                      torch.from_numpy(uemb), num_inference_steps=steps,
                      latent_hw=8, noise=torch.from_numpy(noise), **tkw)
    assert tuple(out.shape) == ref.shape
    return out.numpy(), np.asarray(ref)


@pytest.fixture(scope="module")
def jax_steps(tiny_mvldm):
    """One jitted JAX Euler step per guidance type, ``(params, x, sigma,
    sigma_next) -> (x_next, x0)``: the body of ``_sample_core``'s loop,
    compiled once and run for both ladders."""
    jmodel, _, _, cams = tiny_mvldm
    temb, uemb = (jnp.asarray(e) for e in embeddings())
    jsys = JaxSystem(model=jmodel)
    pose, upose = jsys._pose_embeddings(jnp.asarray(cams), 8, 8)
    steps = {}

    def get(gtype):
        def step(params, x, sigma, sigma_next):
            kv = jsys._text_kv_for_guidance(params, temb, uemb, gtype, 2)
            out = jsys._guided_output(params, x, sigma, temb, uemb, pose,
                                      upose, gtype, 7.5, 0.7, text_kv=kv)
            x0 = jsys.schedule.denoise_output_to_x0(x, out, sigma)
            return jsys.schedule.euler_step(x, x0, sigma, sigma_next), x0

        return steps.setdefault(gtype, jax.jit(step))

    return get


@pytest.mark.parametrize("guidance_type", GUIDANCE)
@pytest.mark.parametrize("steps,tol", [(1, TOL), (2, 1e-3)])
def test_guidance_types_match_jax(tiny_mvldm, jax_steps, guidance_type,
                                  steps, tol):
    _, params, model, cams = tiny_mvldm
    temb, uemb = embeddings()
    noise = np.random.default_rng(3).normal(
        size=(1, 2, 8, 8, 8)).astype(np.float32)
    sigmas = js.make_schedule("vprediction").inference_sigmas(steps)
    x, step = sigmas[0] * jnp.asarray(noise), jax_steps(guidance_type)
    with jax.default_matmul_precision("float32"):
        for i in range(steps):
            x, ref = step(params, x, sigmas[i], sigmas[i + 1])
    out = MVLDMSystem(model=model).sample(
        torch.from_numpy(cams.copy()), torch.from_numpy(temb),
        torch.from_numpy(uemb), num_inference_steps=steps,
        guidance_type=guidance_type, latent_hw=8,
        noise=torch.from_numpy(noise))
    assert scaled_err(out.numpy(), ref) <= tol


@pytest.mark.parametrize("kw,steps", [
    (dict(sampler="dpmpp_2m"), 3),
    (dict(cfg_interval_frac=0.5, sampler="dpmpp_2m",
          guidance_type="hybrid"), 4)])
def test_dpmpp_and_cfg_interval_match_jax(tiny_mvldm, kw, steps):
    out, ref = sample_both(tiny_mvldm, steps, **kw)
    assert scaled_err(out, ref) <= 1e-3


def test_cfg_interval_rounds_half_to_even(tiny_mvldm, monkeypatch):
    """``round(0.5 * 5) == 2`` guided steps, then the conditional row."""
    _, _, model, cams = tiny_mvldm
    temb, uemb = (torch.from_numpy(e) for e in embeddings())
    tsys = MVLDMSystem(model=model)
    seen = []
    guided = tsys._guided_output

    def spy(*args, **kw):
        seen.append(args[6])
        return guided(*args, **kw)

    monkeypatch.setattr(tsys, "_guided_output", spy)
    tsys.sample(torch.from_numpy(cams.copy()), temb, uemb,
                num_inference_steps=5, latent_hw=8, cfg_interval_frac=0.5,
                noise=torch.zeros(1, 2, 8, 8, 8))
    assert seen == ["joint", "joint", "none", "none", "none"]


def test_discrete_timesteps_and_sigma_adjustment_match_jax(tiny_mvldm):
    jsch, tsch = pair("vprediction", {})
    s = np.concatenate([np.asarray(jsch.train_sigmas)[[0, 1, 500, 999]],
                        np.array([0.01, 0.5, 3.3, 1e4], np.float32)])
    jsys = JaxSystem(model=None, timestep_type="discrete")
    tsys = MVLDMSystem(model=None, timestep_type="discrete")
    np.testing.assert_array_equal(
        tsys._t_cond(torch.from_numpy(s)).numpy(),
        np.asarray(jsys._t_cond(jnp.asarray(s))))
    out, ref = sample_both(tiny_mvldm, 2, dict(timestep_type="discrete",
                                               adjust_sigma_on_n=True))
    assert scaled_err(out, ref) <= 1e-3


def test_view_mask_pins_reference_latents(tiny_mvldm):
    rng = np.random.default_rng(4)
    mask = np.zeros((1, 2, 1, 8, 8), np.float32)
    mask[:, 1] = 1.0
    ref_lat = rng.normal(size=(1, 2, 8, 8, 8)).astype(np.float32)
    out, ref = sample_both(tiny_mvldm, 2, view_mask=mask,
                           ref_latents=ref_lat)
    assert scaled_err(out, ref) <= 1e-3
    np.testing.assert_array_equal(out[:, 1], ref_lat[:, 1])


def test_unknown_sampler_and_guidance_raise(tiny_mvldm):
    _, _, model, cams = tiny_mvldm
    emb = torch.zeros(1, 77, 64)
    tsys = MVLDMSystem(model=model)
    with pytest.raises(ValueError, match="sampler"):
        tsys.sample(torch.from_numpy(cams.copy()), emb, emb,
                    num_inference_steps=1, latent_hw=8, sampler="heun")
    with pytest.raises(ValueError, match="guidance type"):
        tsys.sample(torch.from_numpy(cams.copy()), emb, emb,
                    num_inference_steps=1, latent_hw=8, guidance_type="x")


@pytest.mark.parametrize("sampled", [False, True])
def test_encode_image_matches_jax(tiny_mvldm, sampled):
    jmodel, params, model, _ = tiny_mvldm
    rng = np.random.default_rng(5)
    img = rng.uniform(-1, 1, size=(1, 3, 3, 32, 32)).astype(np.float32)
    key = jax.random.PRNGKey(6) if sampled else None
    with jax.default_matmul_precision("float32"):
        ref = jmodel.apply(params, jnp.asarray(img), key,
                           method=JaxMVLDM.encode_image)
    noise = (torch.from_numpy(np.asarray(jax.random.normal(
        key, (3, 4, 8, 8)))) if sampled else None)
    with torch.no_grad():
        out = model.encode_image(torch.from_numpy(img), noise)
    assert out.shape == (1, 3, 4, 8, 8) and out.dtype == torch.float32
    assert scaled_err(out.numpy(), ref) <= TOL


def test_render_to_latent_matches_jax(tiny_mvldm):
    jmodel, params, model, _ = tiny_mvldm
    rng = np.random.default_rng(7)
    img = rng.uniform(-1, 1, size=(1, 2, 3, 32, 32)).astype(np.float32)
    dep = rng.uniform(0.05, 8.0, size=(1, 2, 1, 32, 32)).astype(np.float32)
    jsys = JaxSystem(model=jmodel)
    with jax.default_matmul_precision("float32"):
        ref = jsys.render_to_latent(params, None, None, jnp.asarray(img),
                                    jnp.asarray(dep), None)
    with torch.no_grad():
        out = MVLDMSystem(model=model).render_to_latent(
            torch.from_numpy(img), torch.from_numpy(dep))
    assert out.shape == (1, 2, 8, 8, 8)
    assert scaled_err(out.numpy(), ref) <= TOL


@pytest.fixture(scope="module")
def gs_decoders():
    rng = np.random.default_rng(8)
    jgs = JaxGSDecoder(dtype=jnp.float32, **SMALL_GSDECODER)
    gs_vars = random_params(jgs, rng, jnp.zeros((1, 1, 3, 32, 32)),
                            jnp.zeros((1, 2, 14, 8, 8)),
                            method=JaxGSDecoder.init_everything)
    gs = GSDecoderModel(**SMALL_GSDECODER)
    load_jax_params(gs, gs_vars)
    return jgs, gs_vars, gs.eval()


GS_KW = dict(z_near=0.01, z_far=100.0, s_min=0.001, s_max=1.0)


def test_3d_mode_render_matches_jax(tiny_mvldm, gs_decoders):
    """The render a 3D step re-encodes, from the same x0 latents."""
    jmodel, params, model, cams = tiny_mvldm
    jgs, gs_vars, gs = gs_decoders
    rng = np.random.default_rng(10)
    x0 = rng.normal(size=(1, 2, 8, 8, 8)).astype(np.float32)
    from prometheus_tpu.ops.gaussian import convert_gaussians as jconvert
    from prometheus_tpu.utils.rays import raymap as jraymap

    with jax.default_matmul_precision("float32"):
        jc = jnp.asarray(cams)
        raw = jgs.apply(gs_vars, jnp.concatenate(
            [jnp.asarray(x0), jraymap(jc, 8, 8)], 2),
            method=JaxGSDecoder.decode_latent)
        ref = jax_render(jc, jconvert(raw, jc, **GS_KW), h=32, w=32,
                         backend="xla")
    with torch.no_grad():
        tc = torch.from_numpy(cams.copy())
        raw = gs.decode_latent(torch.cat([torch.from_numpy(x0),
                                          raymap(tc, 8, 8)], 2))
        out = render_gaussians(tc, convert_gaussians(raw, tc, **GS_KW),
                               h=32, w=32)
    for k in (0, 2):                 # images and masks
        err = np.abs(out[k].numpy() - np.asarray(ref[k]))
        assert float(err.mean()) <= 1e-3 and float(err.max()) <= 5e-2
