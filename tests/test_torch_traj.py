"""Port parity for the text-to-trajectory stage: quaternions, trajectory
resampling, the DDIM schedule, the token codecs, TrajDiT and its sampler,
against the JAX package on the CPU in fp32 at the small widths
(``bench.py::build_flagship(small=True)``: hidden 64, 2 blocks, 4 heads,
text width 64).

Tolerances: the quaternion functions ``atol 1e-6`` (a few float32 ulps of
a unit quaternion); ``sample_from_dense_cameras`` ``atol 1e-5`` (slerp's
``arccos`` and ``sin`` near small angles lose a few more); the DDIM
timesteps equal and the alpha-bar table ``atol 1e-7`` (both round the same
float64 table to float32); the token codecs ``atol 1e-6``; the networks
``scaled_err <= 1e-4`` (fp32 sums in another order); ``sample_tokens`` from
the same start noise, 10 steps, ``scaled_err <= 1e-3`` (the DDIM update
divides by sqrt(1 - alpha-bar) and carries each step's rounding on).

Weights are random numpy arrays in the JAX tree's shapes, non-zero
everywhere (flax zeroes ``adaLN_modulation`` and ``out_block``, so a fresh
JAX TrajDiT predicts zeros).

The trunk's CUDA graph replays only on a card (``tests/
test_torch_traj_graph.py``); here every forward runs eagerly, and the tests
hold the rules that decide it and that the eager path is what it was.
"""
import contextlib
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prometheus_tpu.models import dit as jax_dit
from prometheus_tpu.models import traj_dit as jax_traj
from prometheus_tpu.ops import schedulers as jax_sched
from prometheus_tpu.systems.traj_dit_system import TrajDiTSystem as JaxTrajSys
from prometheus_tpu.utils import cameras as jax_cams
from prometheus_tpu.utils import quaternion as jax_quat
from prometheus_torch import profiling
from prometheus_torch.models import dit as torch_dit
from prometheus_torch.models import traj_dit as torch_traj
from prometheus_torch.ops import schedulers as torch_sched
from prometheus_torch.pipeline import SMALL_TRAJ
from prometheus_torch.systems import TrajDiTSystem
from prometheus_torch.utils import cameras as torch_cams
from prometheus_torch.utils import quaternion as torch_quat
from prometheus_torch.weights import load_jax_params
from test_torch_layers_vae import TOL, apply, random_params, scaled_err

QTOL = 1e-6


def t(a):
    return torch.from_numpy(np.asarray(a, np.float32).copy())


def rotations(rng, n):
    """Random rotations plus the hard cases: identity, exact and near
    180-degree turns about the axes and the diagonals (where two pivots tie
    or swap), and quaternions with w < 0 before they become matrices."""
    q = rng.normal(size=(n, 4))
    q[: n // 2, 0] = -np.abs(q[: n // 2, 0])
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    axes = np.array([[1, 0, 0], [0, 1, 0], [0, 0, 1], [1, 1, 0], [1, 0, 1],
                     [0, 1, 1], [1, 1, 1]], np.float64)
    axes /= np.linalg.norm(axes, axis=-1, keepdims=True)
    special = [np.array([1.0, 0, 0, 0])]
    for eps in (0.0, 1e-4, 1e-2):
        half = (math.pi - eps) / 2
        special += [np.concatenate([[math.cos(half)], math.sin(half) * a])
                    for a in axes]
    q = np.concatenate([q, np.stack(special)]).astype(np.float32)
    return q, np.asarray(jax_quat.quaternion_to_matrix(jnp.asarray(q)))


def test_quaternion_to_matrix_and_back(rng):
    q, m = rotations(rng, 64)
    np.testing.assert_allclose(torch_quat.quaternion_to_matrix(t(q)).numpy(),
                               m, atol=QTOL)
    ref = np.asarray(jax_quat.matrix_to_quaternion(jnp.asarray(m)))
    out = torch_quat.matrix_to_quaternion(t(m)).numpy()
    np.testing.assert_allclose(out, ref, atol=QTOL)
    assert (out[:, 0] >= 0).all()
    # the round trip gives q or -q
    sign = np.sign(np.sum(out * q, -1, keepdims=True))
    np.testing.assert_allclose(out * sign, q, atol=1e-3)


def test_quaternion_normalize_and_multiply(rng):
    a = rng.normal(size=(32, 4)).astype(np.float32) * 3
    b = rng.normal(size=(32, 4)).astype(np.float32)
    np.testing.assert_allclose(
        torch_quat.quaternion_normalize(t(a)).numpy(),
        np.asarray(jax_quat.quaternion_normalize(jnp.asarray(a))), atol=QTOL)
    np.testing.assert_allclose(
        torch_quat.quaternion_multiply(t(a), t(b)).numpy(),
        np.asarray(jax_quat.quaternion_multiply(jnp.asarray(a),
                                                jnp.asarray(b))), atol=1e-5)


def test_quaternion_slerp(rng):
    q0 = rng.normal(size=(40, 4)).astype(np.float32)
    q1 = rng.normal(size=(40, 4)).astype(np.float32)
    # near-parallel, exactly parallel and antipodal pairs take the lerp
    # branch; the rest take the short arc
    q1[:5] = q0[:5] + 1e-4 * rng.normal(size=(5, 4))
    q1[5:8] = q0[5:8]
    q1[8:12] = -q0[8:12] * 2.0
    q1[12:14] = -q0[12:14] + 1e-4 * rng.normal(size=(2, 4))
    frac = rng.uniform(0, 1, size=(40,)).astype(np.float32)
    frac[20:22] = (0.0, 1.0)
    ref = np.asarray(jax_quat.quaternion_slerp(jnp.asarray(q0), jnp.asarray(q1),
                                               jnp.asarray(frac)))
    out = torch_quat.quaternion_slerp(t(q0), t(q1), t(frac)).numpy()
    np.testing.assert_allclose(out, ref, atol=QTOL)


def dense_trajectory(rng, b=2, n=29):
    q, m = rotations(rng, b * n)
    m = m[rng.permutation(len(m))[: b * n]]
    pose = np.concatenate([m, rng.normal(size=(b * n, 3, 1))], -1)
    intr = np.stack([rng.uniform(200, 300, b * n), rng.uniform(200, 300, b * n),
                     rng.uniform(240, 270, b * n), rng.uniform(240, 270, b * n),
                     np.full(b * n, 512.0), np.full(b * n, 512.0)], -1)
    return np.concatenate([pose.reshape(b * n, 12), intr], -1).reshape(
        b, n, 18).astype(np.float32)


def test_sample_from_dense_cameras(rng):
    dense = dense_trajectory(rng)
    tq = np.concatenate([np.linspace(0, 1, 120)[None],
                         rng.uniform(0, 1, size=(1, 120))]).astype(np.float32)
    ref = np.asarray(jax_cams.sample_from_dense_cameras(jnp.asarray(dense),
                                                        jnp.asarray(tq)))
    out = torch_cams.sample_from_dense_cameras(t(dense), t(tq)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5)
    # the ends of the trajectory are its first and last cameras
    np.testing.assert_allclose(out[0, 0, 12:], dense[0, 0, 12:], atol=1e-4)
    np.testing.assert_allclose(out[0, -1, 12:], dense[0, -1, 12:], atol=1e-4)


def test_sample_from_two_poses_noise_uses_the_generator(rng):
    dense = t(dense_trajectory(rng, b=1))
    frac = torch.full((1, 6), 0.3)
    a, b = (dense[:, i:i + 6, :12].reshape(1, 6, 3, 4) for i in (0, 1))
    clean = torch_cams.sample_from_two_poses(a, b, frac)
    draw = lambda s: torch_cams.sample_from_two_poses(
        a, b, frac, generator=torch.Generator().manual_seed(s),
        noise_strengths=(0.05, 0.1))
    noisy = draw(3)
    torch.testing.assert_close(noisy, draw(3), rtol=0, atol=0)
    assert float((noisy - clean).abs().max()) > 1e-3
    rot = noisy[..., :3]
    eye = torch.eye(3).expand(rot.shape)
    assert float((rot @ rot.transpose(-1, -2) - eye).abs().max()) < 1e-5


@pytest.mark.parametrize("steps", [100, 10, 4, 7])
def test_ddim_tables_timesteps_and_step(rng, steps):
    jd = jax_sched.make_ddim(kind="scaled_linear", zero_snr=True)
    td = torch_sched.make_ddim(kind="scaled_linear", zero_snr=True)
    np.testing.assert_allclose(td.alphas_cumprod.numpy(),
                               np.asarray(jd.alphas_cumprod), atol=1e-7,
                               rtol=0)
    assert td.alphas_cumprod[-1].item() == 2.0**-24
    ts = td.timesteps(steps)
    assert ts == np.asarray(jd.timesteps(steps)).tolist()
    assert ts[-1] == 9 and ts[0] <= 999
    x = rng.normal(size=(2, 29, 11)).astype(np.float32)
    x0 = rng.normal(size=(2, 29, 11)).astype(np.float32)
    stride = 1000 // steps
    for tt in (ts[0], ts[len(ts) // 2], ts[-1]):
        ref = np.asarray(jd.step(jnp.asarray(x), jnp.asarray(x0), tt,
                                 tt - stride))
        out = td.step(t(x), t(x0), tt, tt - stride).numpy()
        np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6)
    # t_prev < 0 means alpha-bar 1: the step returns the prediction
    np.testing.assert_allclose(td.step(t(x), t(x0), 9, 9 - stride).numpy(),
                               x0, atol=1e-6)
    noise = rng.normal(size=x.shape).astype(np.float32)
    np.testing.assert_allclose(
        td.add_noise(t(x0), t(noise), 509).numpy(),
        np.asarray(jd.add_noise(jnp.asarray(x0), jnp.asarray(noise), 509)),
        atol=1e-6)


def test_scaled_linear_betas():
    for kind in ("linear", "scaled_linear"):
        np.testing.assert_array_equal(torch_sched.make_betas(kind=kind),
                                      jax_sched.make_betas(kind=kind))
    with pytest.raises(ValueError):
        torch_sched.make_betas(kind="cosine")


def test_token_codecs(rng):
    dense = dense_trajectory(rng)
    ref = np.asarray(jax_traj.camera_to_token(jnp.asarray(dense)))
    tok = torch_traj.camera_to_token(t(dense))
    np.testing.assert_allclose(tok.numpy(), ref, atol=QTOL)
    # the intrinsics quirk: fx / H, fy / W, cx / H, cy / W
    np.testing.assert_allclose(tok[..., 7].numpy(),
                               dense[..., 12] / dense[..., 16], atol=QTOL)
    tokens = rng.normal(size=(2, 29, 11)).astype(np.float32)
    # degenerate tokens: zero and tiny quaternions, non-positive focals
    tokens[0, :3, :4] = 0.0
    tokens[0, 3, :4] = 2e-5          # norm 4e-5, under the 1e-4 guard
    tokens[1, :4, 7] = (0.0, -1.0, 1e-4, 1e-3)
    tokens[1, :4, 8] = (-2.0, 0.0, 1e-5, 0.5)
    for size in (512, 64):
        ref = np.asarray(jax_traj.token_to_camera(jnp.asarray(tokens), size))
        cam = torch_traj.token_to_camera(t(tokens), size)
        np.testing.assert_allclose(cam.numpy(), ref, atol=QTOL * size)
        rot = cam[..., :12].reshape(2, 29, 3, 4)[..., :3]
        np.testing.assert_allclose(rot[0, :4].numpy(),
                                   np.broadcast_to(np.eye(3), (4, 3, 3)),
                                   atol=QTOL)
        assert float(cam[..., 12:14].min()) >= 1e-3 * size * (1 - 1e-6)
    # the round trip of a real trajectory
    back = torch_traj.token_to_camera(tok, 512)
    np.testing.assert_allclose(back[..., :12].numpy(), dense[..., :12],
                               atol=1e-4)


def test_cross_attention(rng):
    x = rng.normal(size=(2, 29, 64)).astype(np.float32)
    ctx = rng.normal(size=(2, 77, 64)).astype(np.float32)
    jmod = jax_dit.MultiHeadCrossAttention(4)
    params = random_params(jmod, rng, jnp.asarray(x), jnp.asarray(ctx))
    ref = apply(jmod, params, jnp.asarray(x), jnp.asarray(ctx))
    mod = torch_dit.MultiHeadCrossAttention(64, 4)
    assert load_jax_params(mod, params) == []
    assert scaled_err(mod(t(x), t(ctx)).detach().numpy(), ref) <= TOL


def test_traj_dit_block(rng):
    x = rng.normal(size=(2, 29, 64)).astype(np.float32)
    y = rng.normal(size=(2, 77, 64)).astype(np.float32)
    c = rng.normal(size=(2, 64)).astype(np.float32)
    jmod = jax_traj.TrajDiTBlock(4)
    params = random_params(jmod, rng, jnp.asarray(x), jnp.asarray(y),
                           jnp.asarray(c))
    ref = apply(jmod, params, jnp.asarray(x), jnp.asarray(y), jnp.asarray(c))
    mod = torch_traj.TrajDiTBlock(64, 4)
    assert load_jax_params(mod, params) == []
    assert scaled_err(mod(t(x), t(y), t(c)).detach().numpy(), ref) <= TOL


@pytest.fixture(scope="module")
def traj_models():
    rng = np.random.default_rng(11)
    jmod = jax_traj.TrajDiTModel(dtype=jnp.float32, **SMALL_TRAJ)
    params = random_params(jmod, rng, jnp.zeros((1, 29, 11)),
                           jnp.zeros((1, 77, 64)), jnp.zeros((1,)))
    mod = torch_traj.TrajDiTModel(**SMALL_TRAJ)
    unused = load_jax_params(mod, params)
    return jmod, params, mod.eval(), unused


def test_load_jax_params_traj_tree(traj_models):
    _, params, mod, unused = traj_models
    assert unused == []
    # pos_embed is a raw (1, 29, hidden) parameter: copied, not transposed
    np.testing.assert_array_equal(mod.pos_embed.detach().numpy(),
                                  params["params"]["pos_embed"])
    np.testing.assert_array_equal(
        mod.block_1.cattn.to_q.weight.detach().numpy(),
        params["params"]["block_1"]["cattn"]["to_q"]["kernel"].T)


def test_traj_dit_model(traj_models, rng):
    jmod, params, mod, _ = traj_models
    x = rng.normal(size=(2, 29, 11)).astype(np.float32)
    y = rng.normal(size=(2, 77, 64)).astype(np.float32)
    tt = np.array([909.0, 9.0], np.float32)
    ref = apply(jmod, params, jnp.asarray(x), jnp.asarray(y), jnp.asarray(tt))
    out = mod(t(x), t(y), t(tt)).detach().numpy()
    assert scaled_err(out, ref) <= TOL


def test_sample_tokens(traj_models, rng):
    jmod, params, mod, _ = traj_models
    text = rng.normal(size=(2, 77, 64)).astype(np.float32)
    key = jax.random.PRNGKey(4)
    jsys = JaxTrajSys(model=jmod)
    with jax.default_matmul_precision("float32"):
        ref = np.asarray(jsys.sample_tokens(params, key, jnp.asarray(text),
                                            num_inference_steps=10))
        cams_ref = np.asarray(jsys.inference(params, key, jnp.asarray(text),
                                             num_inference_steps=10,
                                             image_size=64))
    noise = t(jax.random.normal(key, (2, 29, 11)))
    sys_ = TrajDiTSystem(model=mod)
    out = sys_.sample_tokens(t(text), num_inference_steps=10, noise=noise)
    assert out.dtype == torch.float32
    assert scaled_err(out.numpy(), ref) <= 1e-3
    # the last step returns the prediction, whose quaternion is unit
    np.testing.assert_allclose(np.linalg.norm(out[..., :4].numpy(), axis=-1),
                               1.0, atol=1e-5)
    cams = sys_.inference(t(text), num_inference_steps=10, image_size=64,
                          noise=noise)
    assert scaled_err(cams.numpy(), cams_ref) <= 1e-3


def forward_before_graphs(m, x, y, tt):
    """``TrajDiTModel.forward`` as it was before its trunk could replay a
    CUDA graph."""
    y = m.y_embedder(y.to(m.dtype))
    h = m.in_block(x.to(m.dtype)) + m.pos_embed
    c = torch.nn.functional.silu(m.t_embedder(tt))
    for i in range(m.num_blocks):
        h = getattr(m, f"block_{i}")(h, y, c)
    return m.out_block(h)


def _hooked(mod, case):
    """A context in which ``case`` holds for a call of ``mod``."""
    stack = contextlib.ExitStack()
    if case != "grad":
        stack.enter_context(torch.no_grad())
    if case == "autocast":
        stack.enter_context(torch.autocast("cpu", dtype=torch.bfloat16))
    hook = {"trunk_hook": lambda: mod.block_1.mlp.fc1.register_forward_hook(
                lambda *a: None),
            "trunk_pre_hook": lambda: mod.y_embedder.register_forward_pre_hook(
                lambda *a: None),
            "global_hook": lambda: torch.nn.modules.module.
                register_module_forward_pre_hook(lambda *a: None),
            "out_block_hook": lambda: mod.out_block.register_forward_pre_hook(
                lambda *a: None)}.get(case)
    if hook is not None:
        stack.callback(hook().remove)
    return stack


@pytest.mark.parametrize("case, reason", [
    ("none", "device"), ("grad", "grad"), ("autocast", "autocast"),
    ("trunk_hook", "hook"), ("trunk_pre_hook", "hook"),
    ("global_hook", "hook"), ("out_block_hook", "device")])
def test_eager_reason(traj_models, case, reason):
    """Each rule that keeps the trunk eager, checked before the device: a
    CPU input is the last reason, and a hook on ``out_block`` alone is
    none."""
    mod = traj_models[2]
    with _hooked(mod, case):
        assert mod.eager_reason(torch.zeros(2, 29, 11)) == reason
    with torch.no_grad():
        assert mod.eager_reason(torch.zeros(2, 29, 11)) == "device"


def test_sample_tokens_on_cpu_unchanged(traj_models, rng):
    mod = traj_models[2]
    text = t(rng.normal(size=(2, 77, 64)))
    noise = t(rng.normal(size=(2, 29, 11)))
    got = TrajDiTSystem(model=mod).sample_tokens(text, num_inference_steps=7,
                                                 noise=noise)
    want = TrajDiTSystem(model=functools.partial(
        forward_before_graphs, mod)).sample_tokens(
            text, num_inference_steps=7, noise=noise)
    assert torch.equal(got, want)


def test_graph_counter_counts_cpu_forwards_eager(traj_models, rng):
    mod = traj_models[2]
    text = t(rng.normal(size=(1, 77, 64)))
    with torch.profiler.profile():
        TrajDiTSystem(model=mod).sample_tokens(text, num_inference_steps=4)
        with torch.no_grad():
            mod(torch.zeros(1, 29, 11), text, torch.zeros(1))
    assert profiling.counters()["graphs"] == {
        "traj": {"captured": 0, "replayed": 0, "eager": 5}}
    # off, nothing is counted
    TrajDiTSystem(model=mod).sample_tokens(text, num_inference_steps=2)
    assert profiling.counters()["graphs"]["traj"]["eager"] == 5
