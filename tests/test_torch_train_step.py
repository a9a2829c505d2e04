"""The port's train step against ``prometheus_tpu.parallel.train_step`` on
the CPU, and the stage-1 entry point.

Both steps get the same gradients: the loss is linear in the parameters,
``mean(x) * sum(G * p)`` over the trained leaves, with fixed random ``G``
and a batch ``x``, so every micro-batch's gradient is ``mean(x) * G`` in
either framework. A leaf named ``enc_w`` stays out of the loss, as the
frozen VAE encoder does: its gradient is zero, yet optax decays it and so
must the port. The model state (an EMANorm-like magnitude) is moved by each
micro-batch in turn. Two steps, clipping on and off, ``grad_accum`` 1 and 2,
in two variants: stage 1's (``make_optimizer(mu_dtype=None)``, no mask) and
stage 2's (``mu_dtype=bfloat16`` and a frozen mask on ``enc_w``, the JAX
``make_train_step(frozen_mask=...)``). Parameters, second moments, EMA,
``grad_norm``, loss and state within ``rtol 1e-6`` (fp32 updates rounded in
another order); an fp32 first moment too, a bf16 one within one bf16 ulp of
optax's. A frozen leaf has no moments and no EMA and stays bit-unchanged.
"""
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from prometheus_tpu.parallel.train_step import init_train_state as jax_init
from prometheus_tpu.parallel.train_step import make_optimizer as jax_opt
from prometheus_tpu.parallel.train_step import make_train_step as jax_step
from prometheus_torch.parallel import (freeze_, frozen_components,
                                       init_train_state, make_optimizer,
                                       make_train_step)
from prometheus_torch.train import (build_gsdecoder_trainer, build_trainer,
                                    main, parse_args)
from test_torch_sampler_modes import one_thread  # noqa: F401  (fixture)

SHAPES = {"dec_w": (4, 3), "dec_b": (3,), "enc_w": (3, 3)}
TRAINED = ("dec_w", "dec_b")
LR, WD, EMA = 1e-2, 0.1, 0.9


class Toy(nn.Module):
    def __init__(self, params):
        super().__init__()
        for k, v in params.items():
            setattr(self, k, nn.Parameter(torch.tensor(v)))
        self.register_buffer("m", torch.tensor(1.0))


def run_jax(params, G, batches, grad_accum, bf16_frozen=False):
    def loss_fn(p, ms, batch, key):
        s = jnp.mean(batch["x"])
        loss = s * sum(jnp.sum(G[k] * p[k]) for k in TRAINED)
        return loss, ({"s": s}, {"m": 0.5 * ms["m"] + s})

    mask = {k: bf16_frozen and k == "enc_w" for k in SHAPES} \
        if bf16_frozen else None
    tx = jax_opt(learning_rate=LR, weight_decay=WD,
                 mu_dtype=jnp.bfloat16 if bf16_frozen else None)
    state = jax_init({k: jnp.asarray(v) for k, v in params.items()},
                     {"m": jnp.float32(1.0)}, tx, frozen_mask=mask)
    step = jax_step(loss_fn, tx, ema_decay=EMA, grad_accum=grad_accum,
                    donate=False, frozen_mask=mask)
    metrics = []
    for b in batches:
        state, m = step(state, {"x": jnp.asarray(b)}, jax.random.PRNGKey(0))
        metrics.append(m)
    adam = state.opt_state[1][0]
    return dict(params=state.params, mu=adam.mu, nu=adam.nu,
                ema=state.ema_params, m=state.model_state["m"],
                metrics=metrics)


def run_torch(params, G, batches, grad_accum, bf16_frozen=False):
    model = Toy(params)
    trained = freeze_(model, frozen_components("enc_w") if bf16_frozen
                      else None)

    def loss_fn(batch):
        s = batch["x"].mean()
        loss = s * sum((torch.from_numpy(G[k]) * getattr(model, k)).sum()
                       for k in TRAINED)
        with torch.no_grad():
            model.m.copy_(0.5 * model.m + s)
        return loss, {"s": s}

    opt = make_optimizer(trained, learning_rate=LR, weight_decay=WD,
                         mu_dtype=torch.bfloat16 if bf16_frozen else None)
    state = init_train_state(model, opt)
    step = make_train_step(loss_fn, opt, ema_decay=EMA,
                           grad_accum=grad_accum)
    metrics = [step(state, {"x": torch.from_numpy(b)}) for b in batches]
    named = dict(model.named_parameters())
    return dict(
        params={k: named[k].detach() for k in SHAPES},
        mu={k: opt.state[named[k]]["exp_avg"] for k in SHAPES
            if named[k] in opt.state},
        nu={k: opt.state[named[k]]["exp_avg_sq"] for k in SHAPES
            if named[k] in opt.state},
        ema=state.ema_params, m=model.m, metrics=metrics, steps=state.step)


def within_bf16_ulp(a, b):
    """``|a - b|`` at most one bf16 ulp of ``b`` (bf16 keeps 8 bits)."""
    a, b = (np.asarray(torch.as_tensor(np.asarray(x, np.float32)).float())
            for x in (a, b))
    ulp = np.where(b == 0, 0.0, 2.0 ** (np.floor(np.log2(
        np.where(b == 0, 1.0, np.abs(b)))) - 7))
    assert (np.abs(a - b) <= ulp).all(), np.abs(a - b).max()


@pytest.mark.parametrize("variant", ["fp32", "bf16_mu_frozen"])
@pytest.mark.parametrize("grad_accum", [1, 2])
@pytest.mark.parametrize("grad_scale", [1.0, 0.01])   # clipped, not clipped
def test_train_step_matches_jax(rng, grad_accum, grad_scale, variant):
    bf16_frozen = variant == "bf16_mu_frozen"
    params = {k: rng.normal(size=s).astype(np.float32)
              for k, s in SHAPES.items()}
    G = {k: (grad_scale * rng.normal(size=SHAPES[k])).astype(np.float32)
         for k in TRAINED}
    batches = [rng.uniform(0.5, 2.0, size=(4,)).astype(np.float32)
               for _ in range(2)]
    ref = run_jax(params, G, batches, grad_accum, bf16_frozen)
    out = run_torch(params, G, batches, grad_accum, bf16_frozen)
    assert out["steps"] == 2
    close = lambda a, b: np.testing.assert_allclose(
        np.asarray(a), np.asarray(b), rtol=1e-6, atol=1e-7)
    kept = TRAINED if bf16_frozen else tuple(SHAPES)
    assert sorted(out["mu"]) == sorted(ref["mu"]) == sorted(kept)
    assert sorted(out["ema"]) == sorted(ref["ema"]) == sorted(kept)
    for k in SHAPES:
        close(out["params"][k], ref["params"][k])
    for k in kept:
        if bf16_frozen:
            assert out["mu"][k].dtype == torch.bfloat16
            assert ref["mu"][k].dtype == jnp.bfloat16
            within_bf16_ulp(out["mu"][k].float(), ref["mu"][k])
        else:
            close(out["mu"][k], ref["mu"][k])
        close(out["nu"][k], ref["nu"][k])
        close(out["ema"][k], ref["ema"][k])
    if bf16_frozen:
        # the frozen leaf: outside the optimizer and the EMA, unchanged
        assert np.array_equal(out["params"]["enc_w"].numpy(),
                              params["enc_w"])
    else:
        # the untrained leaf: zero gradient, moments zero, decay applied
        assert float(out["mu"]["enc_w"].abs().max()) == 0.0
        assert not np.allclose(out["params"]["enc_w"].numpy(),
                               params["enc_w"])
    close(out["m"], ref["m"])
    for a, b in zip(out["metrics"], ref["metrics"]):
        for k in ("loss", "grad_norm", "s"):
            close(a[k], b[k])
    clipped = float(ref["metrics"][0]["grad_norm"]) > 1.0
    assert clipped == (grad_scale == 1.0)


@pytest.mark.usefixtures("one_thread")
def test_gsdecoder_entry_point_on_cpu(capsys, tmp_path):
    """``python -m prometheus_torch.train --stage gsdecoder --synthetic
    --small --max_steps 2 --device cpu``: finite metrics on every logged
    step, gradients that reach the model, parameters and EMANorm state
    that move, and a checkpoint at the end; ``--param_sharding fsdp``
    gives the same run."""
    trainer = main(["--stage", "gsdecoder", "--synthetic", "--small",
                    "--max_steps", "2", "--device", "cpu", "--log_every",
                    "1", "--ckpt_dir", str(tmp_path)])
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{")]
    assert [ln["step"] for ln in lines] == [0, 1]
    for ln in lines:
        assert {"loss", "grad_norm", "psnr_mv", "loss_mv_image_mse",
                "loss_mv_depth"} <= set(ln)
        assert all(math.isfinite(v) for v in ln.values())
    assert max(ln["grad_norm"] for ln in lines) > 0
    fresh = build_gsdecoder_trainer(small=True, device="cpu", seed=0)
    before = dict(fresh.state.model.named_parameters())
    after = dict(trainer.state.model.named_parameters())
    # every trained leaf that starts nonzero moves (zero-initialised biases
    # move only where a gradient reaches them; the frozen encoder and
    # quant_conv see only decay, lr * wd = 1e-8, which float32 does not
    # resolve, in optax neither)
    for name, p in before.items():
        frozen = name.startswith(("vae.encoder", "vae.quant_conv"))
        if not frozen and bool(p.ne(0).any()):
            assert not torch.equal(p, after[name]), name
    assert not torch.equal(before["cross_view_dit.dit.final_layer.linear.bias"],
                           after["cross_view_dit.dit.final_layer.linear.bias"])
    ema_before = dict(fresh.state.model.named_buffers())
    for name, buf in trainer.state.model.named_buffers():
        assert not torch.equal(buf, ema_before[name]), name
    assert (tmp_path / "step_000000002" / "state.pt").exists()
    # --param_sharding fsdp (alone: one slice a parameter, the whole of it)
    # steps as the replicated run does, bit for bit; --sp_views is the plain
    # mvldm stage's, as in the JAX trainer
    fsdp = main(["--stage", "gsdecoder", "--synthetic", "--small",
                 "--max_steps", "2", "--device", "cpu", "--ckpt_dir",
                 str(tmp_path / "fsdp"), "--param_sharding", "fsdp"])
    assert fsdp.state.sharding is not None
    for name, p in fsdp.state.model.named_parameters():
        assert torch.equal(p, after[name]), name
    for name, v in fsdp.state.full_ema().items():
        assert torch.equal(v, trainer.state.ema_params[name]), name
    with pytest.raises(SystemExit, match="plain mvldm"):
        main(["--stage", "gsdecoder", "--device", "cpu", "--small",
              "--synthetic", "--sp_views", "--ckpt_dir",
              str(tmp_path / "refused")])
    # --depth_teacher da2 (the default, as in the JAX trainer) is accepted
    # under --synthetic and unused: no weights asked for, no teacher built
    synth = build_trainer(parse_args([
        "--stage", "gsdecoder", "--synthetic", "--depth_teacher", "da2",
        "--small", "--device", "cpu"]))
    assert synth.feed is None


@pytest.mark.usefixtures("one_thread")
def test_sp_views_alone_is_the_plain_mvldm_step(tmp_path):
    """``--sp_views`` in a process alone: the view-sharded loss over one
    rank draws as the plain step does (its per-view generator is the shared
    one), so 2 steps leave the same parameters, bit for bit."""
    argv = ["--stage", "mvldm", "--synthetic", "--small", "--max_steps",
            "2", "--device", "cpu"]
    plain = main(argv + ["--ckpt_dir", str(tmp_path / "plain")])
    sp = main(argv + ["--ckpt_dir", str(tmp_path / "sp"), "--sp_views"])
    assert sp.parallel.sp_views
    for (name, a), b in zip(plain.state.model.named_parameters(),
                            sp.state.model.parameters()):
        assert torch.equal(a, b), name
