"""Port parity for the SDS++ refiners against the JAX package on the CPU, in
fp32: the gaussian buffer (``make_buffer``, ``activate``,
``densify_and_prune``), the optimizer, the timestep annealing, both
refiners iteration by iteration, and ``generate`` with a refiner, with 3D
mode and with DPM-Solver++(2M).

The models are the tiny MV-LDM of ``test_torch_sampler`` and the small GS
decoder of ``pipeline.SMALL_GSDECODER`` (random weights in both packages);
the refined scene is 256 random gaussians seen by 5 random cameras at 32^2.
JAX's refiner draws the camera times, the latent noise and the densify
noise inside its loop from split keys: the test makes the same draws with
``jax.random`` and gives them to the port. JAX's per-iteration results
(buffer, learned embedding, loss) are read from the stage functions it
runs through ``call_with_compile_retry``, which the test wraps without
changing what they compute.

Tolerances: the buffer functions ``rtol 1e-6`` (alive masks equal); Adam
``rtol 1e-6`` over three steps; the annealed timesteps equal; the
refiners' activated gaussians, learned embeddings and losses after one and
after three iterations (across a densify round) ``scaled_err <= 1e-3``
(Adam's first steps move each parameter by about its learning rate
whatever the gradient's size, so the gradients' rounding stays at the
level of the renders'); ``generate``'s latents and gaussians ``1e-3``, its
renders at the slice tests' limits (mean absolute error ``<= 1e-3``, max
``<= 5e-2``). 3D mode through ``generate`` is ill-conditioned (see
``test_torch_sampler_modes``): latents ``1e-2``, renders mean absolute
error ``<= 1e-2``. ``generate``'s refinement of a generated scene: 99% of
the gaussians at ``TOL`` (see the test).
"""
import warnings
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from prometheus_tpu.models import clip_text as jax_clip_text
from prometheus_tpu.models.clip_text import CLIPTokenizer as JaxTokenizer
from prometheus_tpu.models.gs_decoder import GSDecoderModel as JaxGSDecoder
from prometheus_tpu.pipeline import PrometheusPipeline as JaxPipeline
from prometheus_tpu.refiners import gs_manager as jgm
from prometheus_tpu.refiners import sds_pp as jsds
from prometheus_tpu.systems.mv_ldm_system import MVLDMSystem as JaxSystem
from prometheus_tpu.utils import get_random_cameras as jax_random_cameras
from prometheus_torch.models import GSDecoderModel
from prometheus_torch.models import clip_text as torch_clip_text
from prometheus_torch.pipeline import SMALL_GSDECODER, PrometheusPipeline
from prometheus_torch.refiners import gs_manager as tgm
from prometheus_torch.refiners import sds_pp as tsds
from prometheus_torch.systems import MVLDMSystem
from prometheus_torch.weights import load_jax_params
from test_torch_layers_vae import random_params, scaled_err
from test_torch_sampler import tiny_mvldm  # noqa: F401  (fixture)
from test_torch_sampler_modes import one_thread  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("one_thread")

N_GAUSS, VIEWS, SIZE = 256, 2, 32
TOL = 1e-3


def scene(seed=3, n=N_GAUSS):
    r = np.random.default_rng(seed)
    d = r.normal(size=(n, 3))
    xyz = 0.5 * d / np.linalg.norm(d, axis=1, keepdims=True) \
        * r.uniform(0, 1, (n, 1)) ** (1 / 3)
    g = (xyz[None], r.uniform(0.1, 0.9, (1, n, 1, 3)),
         r.uniform(0.2, 0.9, (1, n, 1)), r.uniform(0.02, 0.15, (1, n, 3)),
         r.normal(size=(1, n, 4)))
    return tuple(np.asarray(a, np.float32) for a in g)


def close(a, b, rtol=1e-6):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), rtol=rtol,
                               atol=rtol * float(np.abs(np.asarray(b)).max()))


def buffers(capacity, seed=3, n=N_GAUSS):
    g = scene(seed, n)
    return (jgm.make_buffer(tuple(map(jnp.asarray, g)), capacity),
            tgm.make_buffer(tuple(map(torch.from_numpy, g)), capacity))


@pytest.mark.parametrize("batched", [True, False])
def test_make_buffer_and_activate_match_jax(batched):
    g = scene()
    if not batched:
        g = tuple(a[0] for a in g)
    jb = jgm.make_buffer(tuple(map(jnp.asarray, g)), 400)
    tb = tgm.make_buffer(tuple(map(torch.from_numpy, g)), 400)
    for a, b in zip(tb, jb):
        close(a.numpy(), b)
    assert int(tgm.num_alive(tb)) == int(jgm.num_alive(jb)) == N_GAUSS
    for a, b in zip(tgm.activate(tb), jgm.activate(jb)):
        assert a.shape == b.shape
        close(a.numpy(), b)
    with pytest.raises(ValueError, match="capacity"):
        tgm.make_buffer(tuple(map(torch.from_numpy, g)), N_GAUSS - 1)


def test_activate_guards_small_quaternions():
    """A quaternion of norm <= 1e-4 activates to the identity with a zero
    gradient, as in JAX (the double ``where``). At an exactly zero
    quaternion JAX's gradient is NaN (the norm's gradient at 0) and the
    port's 0: the rows from 1 on are compared."""
    _, tb = buffers(300)
    rots = tb.rots_raw.clone()
    rots[0] = 0.0
    rots[1] = torch.tensor([1e-5, 0.0, 0.0, 0.0])
    rots[2] = torch.tensor([3e-4, 0.0, -2e-4, 1e-4])
    jb = jgm.GaussianBuffer(*(jnp.asarray(x.numpy()) for x in tb[:4]),
                            jnp.asarray(rots.numpy()),
                            jnp.asarray(tb.alive.numpy()))
    w = np.random.default_rng(4).normal(size=(1, 300, 4)).astype(np.float32)
    jgrad = jax.grad(lambda r: jnp.sum(jgm.activate(jb._replace(
        rots_raw=r))[4] * w))(jb.rots_raw)
    r = rots.requires_grad_()
    out = tgm.activate(tb._replace(rots_raw=r))[4]
    (tgrad,) = torch.autograd.grad((out * torch.from_numpy(w)).sum(), r)
    close(out.detach().numpy(), jgm.activate(jb)[4])
    assert torch.equal(out[0, :2].detach(),
                       torch.tensor([[1.0, 0, 0, 0]] * 2))
    assert bool(torch.isfinite(tgrad).all())
    assert float(tgrad[:2].abs().max()) == 0.0
    close(tgrad[1:].numpy(), np.asarray(jgrad)[1:], rtol=1e-5)


# (capacity, max_new, grad scale): room for every candidate; more
# candidates than free slots; more candidates than max_new; max_new above
# the capacity (k = C)
DENSIFY_CASES = [(600, 4096, 1e-3), (300, 4096, 1e-3), (600, 7, 1e-3),
                 (280, 100000, 5e-4)]


@pytest.mark.parametrize("capacity,max_new,scale", DENSIFY_CASES)
def test_densify_and_prune_matches_jax(capacity, max_new, scale):
    jb, tb = buffers(capacity)
    r = np.random.default_rng(5)
    stat = (r.uniform(0, 1, capacity) * scale).astype(np.float32)
    key = jax.random.PRNGKey(6)
    k = min(max_new, capacity)
    kw = dict(max_new=max_new, opacity_prune=0.3, scale_prune_max=0.14)
    ref = jgm.densify_and_prune(jb, jnp.asarray(stat), key, **kw)
    noise = torch.from_numpy(np.asarray(jax.random.normal(key, (k, 3))))
    out = tgm.densify_and_prune(tb, torch.from_numpy(stat), noise=noise, **kw)
    for name, a, b in zip(tgm.GaussianBuffer._fields, out, ref):
        if name == "alive":
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        else:
            close(a.numpy(), b)
    cand = int(((stat > 2e-4) & tb.alive.numpy()).sum())
    born = int((~tb.alive & out.alive).sum())    # copies that survive
    assert 0 < born <= min(cand, max_new, capacity - N_GAUSS)


def test_densify_draws_from_a_generator():
    _, tb = buffers(400)
    stat = torch.full((400,), 1e-3)
    outs = [tgm.densify_and_prune(
        tb, stat, generator=torch.Generator().manual_seed(0)) for _ in "ab"]
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    assert int(outs[0].alive.sum()) > N_GAUSS


def test_adam_matches_optax():
    r = np.random.default_rng(7)
    params = {k: r.normal(size=(5, 3)).astype(np.float32)
              for k in tsds.DEFAULT_LRS}
    labels = {k: k for k in params}
    tx = optax.multi_transform(
        {k: optax.adam(v) for k, v in tsds.DEFAULT_LRS.items()}, labels)
    state = tx.init(params)
    jp = dict(params)
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    opt = tsds.Adam(tsds.DEFAULT_LRS, tp)
    for step in range(4):
        if step == 2:                       # a densify round's reset
            state = tx.init(jp)
            opt.reset(tp)
        grads = {k: r.normal(size=(5, 3)).astype(np.float32) * 10.0 ** -step
                 for k in params}
        upd, state = tx.update(grads, state, jp)
        jp = optax.apply_updates(jp, upd)
        tp = opt.step(tp, {k: torch.from_numpy(v) for k, v in grads.items()})
        for k in params:
            close(tp[k].numpy(), jp[k])


@pytest.mark.parametrize("total", [300, 30, 7])
def test_timestep_annealing_matches_jax(total):
    kw = dict(denoise_fn=None, encode_fn=None, decode_fn=None,
              total_iterations=total)
    jr, tr = jsds.GSRefinerSDSPlusPlus(**kw), tsds.GSRefinerSDSPlusPlus(**kw)
    got = [tr._t_for_iter(i) for i in range(total)]
    want = np.asarray(jax.vmap(jr._t_for_iter)(
        jnp.arange(total, dtype=jnp.float32)))
    assert got == want.tolist()
    assert got[0] == 750 and min(got) >= 20


def pipelines(tiny):
    jmodel, params, model, _ = tiny
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jpipe = JaxPipeline(mvldm=JaxSystem(model=jmodel), mvldm_params=params,
                            traj=None, traj_params=None, gsdecoder=None,
                            gsdecoder_vars=None)
    return jpipe, PrometheusPipeline(mvldm=MVLDMSystem(model=model),
                                     gsdecoder=None)


def refine_draws(key, kind, iters, interval, capacity):
    """The draws JAX's ``refine_gaussians`` makes from ``key``."""
    shape = ((VIEWS, 4, 8, 8) if kind == "sds"
             else (1, VIEWS, 8, 8, 8))
    draws, k = [], key
    as_t = lambda a: torch.from_numpy(np.asarray(a))
    for i in range(iters):
        k, k_i = jax.random.split(k)
        d = {}
        if i > 0 and i % interval == 0:
            k, k_d = jax.random.split(k)
            d["densify_noise"] = as_t(jax.random.normal(
                k_d, (min(4096, capacity), 3)))
        k_cam, k_noise = jax.random.split(k_i)
        d["ts"] = as_t(jax.random.uniform(k_cam, (1, VIEWS)))
        d["noise"] = as_t(jax.random.normal(k_noise, shape))
        draws.append(d)
    return draws


ITERS, INTERVAL = 3, 2


def densify_key(key, at):
    """The key of the densify round JAX's loop runs at iteration ``at``."""
    for _ in range(at + 1):
        key, _ = jax.random.split(key)
    return jax.random.split(key)[1]


@pytest.fixture(scope="module")
def jax_runs(tiny_mvldm):
    """JAX's 3-iteration refine of each kind (a densify round before the
    third iteration), made on first use, with each iteration's
    ``grad_and_update`` result."""
    runs = {}

    def get(kind):
        if kind not in runs:
            runs[kind] = jax_refine(tiny_mvldm, kind)
        return runs[kind]

    return get


def jax_refine(tiny, kind):
    jpipe, _ = pipelines(tiny)
    stages = []
    run = jsds.call_with_compile_retry

    def recorded(fn, *args, **kw):
        out = run(fn, *args, **kw)
        stages.append((fn.__name__, out))
        return out

    r = np.random.default_rng(8)
    temb, uemb = (r.normal(size=(1, 77, 64)).astype(np.float32)
                  for _ in range(2))
    dense = np.asarray(jax_random_cameras(jax.random.PRNGKey(2), 5,
                                          size=SIZE))[None]
    refiner = jpipe.build_refiner(kind, total_iterations=ITERS,
                                  img_size=SIZE, num_views=VIEWS,
                                  densification_interval=INTERVAL)
    key = jax.random.PRNGKey(11)
    with pytest.MonkeyPatch.context() as mp, \
            jax.default_matmul_precision("float32"):
        mp.setattr(jsds, "call_with_compile_retry", recorded)
        out = refiner.refine_gaussians(tuple(map(jnp.asarray, scene())),
                                       jnp.asarray(temb), jnp.asarray(uemb),
                                       jnp.asarray(dense), key)
    updates = [o for name, o in stages if name == "grad_and_update"]
    return dict(out=out, updates=updates, temb=temb, uemb=uemb, dense=dense,
                key=key)


def port_refine(tiny, kind, ref, iters):
    """The port's refine of ``iters`` iterations from JAX's draws (its
    first iteration is JAX's: the annealed t of iteration 0 is 750 for any
    total)."""
    _, tpipe = pipelines(tiny)
    refiner = tpipe.build_refiner(kind, total_iterations=iters,
                                  img_size=SIZE, num_views=VIEWS,
                                  densification_interval=INTERVAL)
    log = []
    out = refiner.refine_gaussians(
        tuple(map(torch.from_numpy, scene())), torch.from_numpy(ref["temb"]),
        torch.from_numpy(ref["uemb"]), torch.from_numpy(ref["dense"]),
        draws=refine_draws(ref["key"], kind, iters, INTERVAL,
                           int(N_GAUSS * 1.5)), log=log)
    return out, log


@pytest.mark.parametrize("kind", ["mv_sds", "sds"])
def test_refiner_one_iteration_matches_jax(tiny_mvldm, jax_runs, kind):
    ref = jax_runs(kind)
    out, log = port_refine(tiny_mvldm, kind, ref, 1)
    buf, learn_emb, _, loss, _ = ref["updates"][0]
    for a, b in zip(out, jgm.activate(buf)):
        assert a.shape == b.shape
        assert scaled_err(a.numpy(), b) <= TOL
    assert len(log) == 1 and log[0]["t"] == 750
    assert abs(float(log[0]["loss"]) - float(loss)) <= TOL * abs(float(loss))
    if kind == "sds":           # LoDS moves the embedding
        assert float(np.abs(np.asarray(learn_emb)).max()) > 0
        assert scaled_err(log[0]["learn_emb"].numpy(), learn_emb) <= TOL
    else:
        assert float(log[0]["learn_emb"].abs().max()) == 0.0


@pytest.mark.parametrize("kind", ["mv_sds", "sds"])
def test_refiner_three_iterations_match_jax(tiny_mvldm, jax_runs, kind,
                                            monkeypatch):
    """Iterations 0 and 1 against JAX's; the densify round before
    iteration 2 against JAX's ``densify_and_prune`` on the same inputs (the
    port's buffer and statistic, JAX's draw); then iteration 2 as a first
    Adam step (the moments restarted).

    The round itself is not compared end to end: it copies the top-k
    candidates by gradient statistic, and two candidates whose statistics
    lie within the 1e-5 the packages' gradients differ by can trade ranks,
    so their copies trade slots and densify draws (1.48791 and 1.48789 in
    one run); what follows differs as a different scene would."""
    ref = jax_runs(kind)
    rounds = []
    densify = tsds.densify_and_prune

    def spy(buf, stat, **kw):
        out = densify(buf, stat, **kw)
        rounds.append((buf, stat, kw, out))
        return out

    monkeypatch.setattr(tsds, "densify_and_prune", spy)
    out, log = port_refine(tiny_mvldm, kind, ref, ITERS)
    assert [e["t"] for e in log] == [750, 328, 153]
    for e, u in zip(log[:2], ref["updates"][:2]):
        assert abs(float(e["loss"]) - float(u[3])) <= TOL * abs(float(u[3]))
    (buf, stat, kw, new), = rounds
    jbuf, _, _, _, jstat = ref["updates"][1]
    for a, b in zip(tgm.activate(buf), jgm.activate(jbuf)):
        assert scaled_err(a.numpy(), b) <= TOL
    assert scaled_err(stat.numpy(), np.asarray(jstat) / INTERVAL) <= TOL
    assert kw["opacity_prune"] == 0.01
    draws = refine_draws(ref["key"], kind, ITERS, INTERVAL,
                         int(N_GAUSS * 1.5))
    assert torch.equal(kw["noise"], draws[2]["densify_noise"])
    want = jgm.densify_and_prune(
        jgm.GaussianBuffer(*(jnp.asarray(x.numpy()) for x in buf)),
        jnp.asarray(stat.numpy()), densify_key(ref["key"], INTERVAL),
        opacity_prune=0.01)
    for name, a, b in zip(tgm.GaussianBuffer._fields, new, want):
        if name == "alive":
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        else:
            close(a.numpy(), b)
    np.testing.assert_array_equal(new.alive.numpy(),
                                  np.asarray(ref["updates"][2][0].alive))
    assert int(log[2]["alive_before"]) == N_GAUSS
    assert int(log[2]["alive_after"]) == int(new.alive.sum()) > N_GAUSS
    # iteration 2 is a first Adam step: each position coordinate with a
    # gradient well above eps moves by its learning rate
    step = (out[0][0] - new.xyz)[new.alive].abs()
    lr = tsds.DEFAULT_LRS["xyz"]
    assert float(step.max()) <= lr * (1 + 1e-3)
    assert float((step > 0.99 * lr).float().mean()) > 0.5


def test_refiner_draws_from_a_generator(tiny_mvldm):
    _, tpipe = pipelines(tiny_mvldm)
    refiner = tpipe.build_refiner("mv_sds", total_iterations=2,
                                  img_size=SIZE, num_views=VIEWS)
    dense = torch.from_numpy(np.asarray(jax_random_cameras(
        jax.random.PRNGKey(2), 5, size=SIZE))[None])
    emb = torch.zeros(1, 77, 64)
    outs = [refiner.refine_gaussians(
        tuple(map(torch.from_numpy, scene())), emb, emb, dense,
        generator=torch.Generator().manual_seed(1)) for _ in "ab"]
    for a, b in zip(*outs):
        assert torch.equal(a, b) and bool(torch.isfinite(a).all())
    with pytest.raises(ValueError, match="refiner kind"):
        tpipe.build_refiner("nerf")


# -- generate ---------------------------------------------------------------

PROMPT = "a cozy wooden cabin in a snowy forest"


def stable_hash(token: str) -> int:
    return zlib.crc32(token.encode("utf-8"))


@pytest.fixture(scope="module")
def gen_pipelines(tiny_mvldm):
    """The tiny MV-LDM and the small GS decoder as a JAX and a port
    pipeline; the tokenizers' salted ``hash`` fallback swapped for CRC-32
    (as in ``test_torch_slice``) so every run sees the same ids."""
    jmodel, params, model, cams = tiny_mvldm
    rng = np.random.default_rng(8)
    jgs = JaxGSDecoder(dtype=jnp.float32, **SMALL_GSDECODER)
    gs_vars = random_params(jgs, rng, jnp.zeros((1, 1, 3, 32, 32)),
                            jnp.zeros((1, 2, 14, 8, 8)),
                            method=JaxGSDecoder.init_everything)
    gs = GSDecoderModel(**SMALL_GSDECODER)
    load_jax_params(gs, gs_vars)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jpipe = JaxPipeline(mvldm=JaxSystem(model=jmodel), mvldm_params=params,
                            traj=None, traj_params=None, gsdecoder=jgs,
                            gsdecoder_vars=gs_vars, tokenizer=JaxTokenizer())
        tpipe = PrometheusPipeline(mvldm=MVLDMSystem(model=model),
                                   gsdecoder=gs.eval())
    with pytest.MonkeyPatch.context() as mp:
        for module in (jax_clip_text, torch_clip_text):
            mp.setattr(module, "hash", stable_hash, raising=False)
        yield jpipe, tpipe, cams


def generate_both(pipes, steps, refine=None, **kw):
    jpipe, tpipe, cams = pipes
    key = jax.random.PRNGKey(12)
    jkw, tkw = dict(kw), dict(kw)
    if refine:
        rkw = dict(total_iterations=2, img_size=SIZE, num_views=VIEWS)
        jkw["refiner"] = jpipe.build_refiner(refine, **rkw)
        # the port's refiner is given the draws JAX's makes from ``key``
        refiner = tpipe.build_refiner(refine, **rkw)
        run, draws = refiner.refine_gaussians, refine_draws(key, refine, 2,
                                                            100, 3072)
        refiner.refine_gaussians = lambda *a, **k: run(*a, draws=draws, **k)
        tkw["refiner"] = refiner
    common = dict(num_inference_steps=steps, render_size=SIZE, num_views=2)
    with jax.default_matmul_precision("float32"):
        ref = jpipe.generate(PROMPT, key, cameras=jnp.asarray(cams),
                             **common, **jkw)
    _, k_mv = jax.random.split(key)
    noise = torch.from_numpy(np.asarray(jax.random.normal(
        k_mv, (1, 2, 8, 8, 8))))
    out = tpipe.generate(PROMPT, cameras=torch.from_numpy(cams.copy()),
                         noise=noise, **common, **tkw)
    out["noise"] = noise
    return ref, out


def render_close(a, b, mean_tol=1e-3, max_tol=5e-2):
    err = np.abs(a.numpy() - np.asarray(b))
    assert float(err.mean()) <= mean_tol and float(err.max()) <= max_tol


@pytest.fixture(scope="module")
def refined_dpmpp(gen_pipelines):
    """One ``generate`` in both packages: 3 DPM-Solver++(2M) steps with
    hybrid guidance on the first half, then a 2-iteration MV-SDS++ refine;
    the arguments each package's ``refine_gaussians`` was called with."""
    calls = {}

    def held(name, refiner):
        run = refiner.refine_gaussians

        def refine(*args, **kw):
            calls[name] = (args, kw)
            return run(*args, **kw)

        refiner.refine_gaussians = refine
        return refiner

    jpipe, tpipe, _ = gen_pipelines
    jbuild, tbuild = jpipe.build_refiner, tpipe.build_refiner
    jpipe.build_refiner = lambda *a, **k: held("jax", jbuild(*a, **k))
    tpipe.build_refiner = lambda *a, **k: held("port", tbuild(*a, **k))
    try:
        ref, out = generate_both(gen_pipelines, 3, refine="mv_sds",
                                 sampler="dpmpp_2m", guidance_type="hybrid",
                                 cfg_interval_frac=0.5)
    finally:
        del jpipe.build_refiner, tpipe.build_refiner
    return ref, out, calls


def test_generate_with_dpmpp_matches_jax(refined_dpmpp):
    ref, out, _ = refined_dpmpp
    assert scaled_err(out["latents_pred"].numpy(),
                      ref["latents_pred"]) <= TOL
    for a, b, tol in zip(out["gaussians"], ref["gaussians"],
                         (TOL, TOL, TOL, TOL, 5e-3)):
        assert scaled_err(a.numpy(), b) <= tol
    render_close(out["images_gs_render"], ref["images_gs_render"])
    assert list(out["timings"]) == ["encode_text", "sample", "decode_2d",
                                    "decode_gaussians", "render", "refine"]


def test_generate_with_3d_mode_matches_jax(gen_pipelines):
    """4 Euler steps with m = 2: 3D steps at i = 1 and 3 (guidance boosted
    to 15). The loop is ill-conditioned, so its latents are held at 1e-2:
    the port's own result moves by more than 1e-3 when its start moves by
    1e-6 (checked here), and its renders at mean absolute error 1e-2."""
    _, tpipe, cams = gen_pipelines
    seen = []
    to_latent = tpipe.mvldm.render_to_latent
    tpipe.mvldm.render_to_latent = lambda i, d: (seen.append(i.shape)
                                                 or to_latent(i, d))
    try:
        ref, out = generate_both(gen_pipelines, 4,
                                 use_3d_mode_every_m_steps=2)
        again = tpipe.generate(
            PROMPT, cameras=torch.from_numpy(cams.copy()),
            noise=out["noise"] * (1 + 1e-6), num_inference_steps=4,
            render_size=SIZE, num_views=2, use_3d_mode_every_m_steps=2)
    finally:
        del tpipe.mvldm.render_to_latent
    assert seen[:2] == [(1, 2, 3, 32, 32)] * 2 and len(seen) == 4
    assert scaled_err(out["latents_pred"].numpy(),
                      ref["latents_pred"]) <= 1e-2
    assert scaled_err(again["latents_pred"].numpy(),
                      out["latents_pred"].numpy()) > 1e-3
    render_close(out["images_gs_render"], ref["images_gs_render"],
                 mean_tol=1e-2, max_tol=0.5)
    with pytest.raises(ValueError, match="euler"):
        tpipe.generate(PROMPT, cameras=torch.from_numpy(cams.copy()),
                       use_3d_mode_every_m_steps=2, sampler="dpmpp_2m")
    with pytest.raises(ValueError, match="must not be 1"):
        tpipe.mvldm.sample_with_3d_mode(
            None, torch.from_numpy(cams.copy()), None, None,
            use_3d_mode_every_m_steps=1)


def test_generate_with_refiner_matches_jax(gen_pipelines, refined_dpmpp):
    """``generate`` hands the refiner the scene, the first prompt's
    embeddings and the dense cameras, and renders what it returns.

    The inputs are held against JAX's at ``generate``'s tolerances. The
    refinement is held on JAX's own inputs: Adam moves a raw parameter by
    about its learning rate whatever its gradient's size, so where a
    gradient cancels to near 0 the two packages' last bits can give it
    opposite signs and the parameter opposite steps (3 opacities of 3,072
    gaussians in 2 iterations on one such scene, the far splats of the
    random decoder); 99% of the gaussians are held at ``TOL`` and the
    refined render of JAX's refined scene at the render limits."""
    ref, out, calls = refined_dpmpp
    _, tpipe, cams = gen_pipelines
    (jg, jt, ju, jd, _), _ = calls["jax"]
    (tg, tt, tu, td), tkw = calls["port"]
    for a, b, tol in zip(tg, jg, (TOL, TOL, TOL, TOL, 5e-3)):
        assert scaled_err(a.numpy(), b) <= tol
    assert tt.shape == ju.shape == (1, 77, 64)
    assert scaled_err(tt.numpy(), jt) <= TOL
    assert scaled_err(tu.numpy(), ju) <= TOL
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    assert len(tkw["draws"]) == 2
    refiner = tpipe.build_refiner("mv_sds", total_iterations=2,
                                  img_size=SIZE, num_views=VIEWS)
    again = refiner.refine_gaussians(
        tuple(torch.from_numpy(np.asarray(g)) for g in jg),
        torch.from_numpy(np.asarray(jt)), torch.from_numpy(np.asarray(ju)),
        torch.from_numpy(np.asarray(jd)), draws=tkw["draws"])
    for a, b in zip(again, ref["gaussians_sds"]):
        assert a.shape == b.shape == (1, 3072) + b.shape[2:]
        a, b = a.numpy()[0].reshape(3072, -1), np.asarray(b)[0].reshape(
            3072, -1)
        off = np.abs(a - b).max(-1) > TOL * np.abs(b).max()
        assert off.mean() <= 0.01
    for name in ("images_sds_gs_render", "depths_sds_gs_render"):
        assert tuple(out[name].shape) == ref[name].shape
        assert bool(torch.isfinite(out[name]).all())
    imgs, _, _ = tpipe.render_views_chunked(
        torch.from_numpy(cams.copy()),
        tuple(torch.from_numpy(np.asarray(g)) for g in ref["gaussians_sds"]),
        h=SIZE, w=SIZE)
    render_close(imgs, ref["images_sds_gs_render"])
