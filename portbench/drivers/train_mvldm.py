"""Stage-2 training through ``prometheus_torch.train``'s trainer
(``build_mvldm_trainer(joint_sv=True)``): the multi-view and single-view
latent losses through the multi-view U-Net (kernels A and A-bwd), the
frozen VAE encoder, global-norm clipping, AdamW with the bf16 first
moment and the EMA, one ``Trainer.step(batch)`` a unit.

Set-up builds the trainer once, gives it the benchmark's weights from the
seed, and drives it through its first three steps with the window's own
call on three distinct batches of the pool; the window goes on with the
same trainer. The plain float32 reference follows those three steps from
the same weights, batches and draws (the trainer's generator state before
each step): each step's loss, the first step's gradient as the optimizer
holds it (its bf16 first moment over ``1 - b1``) leaf by leaf, and each
leaf's change over the three steps.
"""
from __future__ import annotations

import torch

from portbench import common, weights

# ``loss`` is read and not compared here: on one seed the program's gap
# reads 0.0103, the fp8 control's least 0.0115, so that no limit holds
# between them (PERF.md, section 6)
NUMBERS = ("grad", "update", "ema")
FOLLOWED = 3


def _leaf_norms(tensors: dict) -> dict:
    return {n: float(torch.linalg.vector_norm(t.float()))
            for n, t in tensors.items()}


def worst_leaf(got: dict, want: dict, skip=frozenset()) -> float:
    """The largest ``|norm_got - norm_want| / max(norm_want, median
    norm_want)`` over the leaves not in ``skip``."""
    keys = [k for k in want if k not in skip]
    med = float(torch.tensor([want[k] for k in keys]).median())
    return max(abs(got[k] - want[k]) / max(want[k], med, 1e-30)
               for k in keys)


class Driver:
    work = "steps"
    numbers_compared = NUMBERS
    rank = 0

    def __init__(self, cfg: dict, mix: dict, seed: int, device):
        from prometheus_torch import train

        self.cfg, self.mix, self.seed, self.device = cfg, mix, seed, device
        self.trainer = train.build_mvldm_trainer(
            device=device, seed=int(common.sub_seed(seed, 7) % (1 << 62)),
            batch_size=mix["batch"], joint_sv=True,
            overrides=dict(num_views=mix["views"],
                           images_per_iter=mix["images_sv"],
                           image_size=mix["image_size"],
                           model=dict(cfg["mvldm"], use_checkpoint=True)),
            parallel=self.parallel())
        model = self.trainer.state.model
        weights.fill_(model, common.generator(device, seed, 8))
        with torch.no_grad():
            named = dict(model.named_parameters())
            for n, e in self.trainer.state.ema_params.items():
                e.copy_(named[n])
        self.pool = self.make_pool(self.rank, mix["pool"])
        self.timings: list = []
        self.shapes = common.AttentionShapes()
        self.losses, self.gen_states = [], []

    def parallel(self):
        """The trainer's ``Parallel``: None, a process alone."""
        return None

    def make_pool(self, rank: int, n: int) -> list:
        """The first ``n`` seeded batches of the pool (``rank``'s: see
        ``train_mvldm_dp``)."""
        from portbench.reference.training import synthetic_mvldm_batch

        cfg, mix = self.cfg, self.mix
        g = common.generator(self.device, self.seed, 9,
                             *([rank] if rank else []))
        return [synthetic_mvldm_batch(
            g, mix["batch"], mix["views"], mix["image_size"],
            cfg["mvldm"]["context_dim"], sv=mix["images_sv"],
            device=self.device) for _ in range(n)]

    def followed_batch(self, i: int) -> dict:
        """The batch the reference follows at step ``i``."""
        return self.pool[i % len(self.pool)]

    def own_rows(self, B: int) -> range:
        """The first scene of each block of rows the reference runs."""
        return range(0, B, self.mix["reference_rows"])

    def reduce_reference(self, total: float, grads: dict) -> float:
        """The reference's loss and gradients over the shards: one shard,
        nothing to add."""
        return total

    def latent_hw(self) -> int:
        mult = self.cfg["mvldm"]["vae_ch_mult"]
        return self.mix["image_size"] // 2 ** (len(mult) - 1)

    def _trained(self) -> dict:
        held = {id(p) for grp in self.trainer.state.optimizer.param_groups
                for p in grp["params"]}
        return {n: p for n, p in self.trainer.state.model.named_parameters()
                if id(p) in held}

    def _follow(self):
        """The first ``FOLLOWED`` steps, recorded for the comparison."""
        trained = self._trained()
        start = {n: p.detach().clone() for n, p in trained.items()}
        ema = self.trainer.state.ema_params
        opt = self.trainer.state.optimizer
        b1 = opt.param_groups[0]["betas"][0]
        for i in range(FOLLOWED):
            self.gen_states.append(self.trainer.generator.get_state())
            out = self.trainer.step(self.pool[i % len(self.pool)])
            self.losses.append(float(out["loss"]))
            if i == 0:
                # an optimizer that never stepped holds no moment: zero
                self.grad_norms = _leaf_norms(
                    {n: opt.state[p].get("exp_avg", torch.zeros(())).float()
                     / (1.0 - b1) for n, p in trained.items()})
        self.change_norms = _leaf_norms(
            {n: p.detach() - start[n] for n, p in trained.items()})
        self.ema_norms = _leaf_norms({n: ema[n] - start[n] for n in ema})
        del start

    def warmup(self):
        """The followed steps, which run every shape of the window."""
        self._follow()

    def record(self):
        self._follow()

    def unit(self, i: int):
        out = self.trainer.step(self.pool[(FOLLOWED + i) % len(self.pool)])
        return 1, torch.isfinite(out["loss"]).all()

    def end_to_end(self, units: int, work: int, window_s: float) -> dict:
        return {"train_step_s": window_s / work}

    def trace_on(self):
        self.shapes.on()

    def trace_off(self):
        self.shapes.off()

    def layer_context(self) -> dict:
        return {"attn_fwd": self.shapes.fwd, "attn_bwd": self.shapes.bwd,
                "flops_per_unit": self.flops_per_unit()}

    def flops_per_unit(self) -> float:
        """Model FLOPs of one step on the plain reference on the meta
        device, without recomputation: the frozen VAE encoder's forward
        and the U-Net's forward and backward on the multi-view and the
        single-view batch."""
        from portbench.reference import mv_ldm, training

        cfg, m = self.cfg, self.mix
        with torch.device("meta"):
            model = mv_ldm.MVLDMModel(**dict(cfg["mvldm"],
                                             use_checkpoint=False)).train()
            model.vae.requires_grad_(False)
            model.text_encoder.requires_grad_(False)
            batch = {k: torch.zeros_like(v, device="meta")
                     for k, v in self.pool[0].items()}
            B, N, hw = m["batch"], m["views"], self.latent_hw()

            def draws(b, n):
                return {"sigmas": torch.ones(b), "ref_views": torch.zeros(
                    0, dtype=torch.long), "noise": torch.zeros(
                    b, n, 8, hw, hw), "keep_pose": torch.ones(
                    b, dtype=torch.bool), "keep_text": torch.ones(
                    b, dtype=torch.bool), "encode_noise": torch.zeros(
                    b, 2 * n, 4, hw, hw)}

            sv = training.sv_batch(batch, training.dummy_sv_camera(
                m["image_size"]).to("meta"))

            def step():
                loss = training.multi_view_loss(
                    model, batch, draws(B, N), slice(None)) + \
                    training.multi_view_loss(
                        model, sv, draws(B * m["images_sv"], 1),
                        slice(None))
                loss.backward()

            return common.meta_flops(step)

    def release(self):
        self.trainer = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the comparison ----------------------------------------------------
    def reference_model(self, control: bool = False):
        """The reference MV-LDM in float32 from the same seed, its U-Net
        trained; with ``control``, every linear and convolution computes
        on fp8-rounded weights and inputs (straight through for the
        gradient) under bf16 autocast."""
        from portbench.reference import mv_ldm
        from portbench.reference.precision import fp8_ste_

        model = weights.make([(mv_ldm.MVLDMModel, dict(
            self.cfg["mvldm"], use_checkpoint=True))], None, self.device,
            torch.float32, generator=common.generator(self.device, self.seed,
                                                      8))[0]
        model.train()
        model.unet.requires_grad_(True)
        if control:
            fp8_ste_(model.unet)
        return model

    def follow(self, control: bool = False) -> dict:
        """The reference's three steps: ``{"losses", "grad_norms",
        "change_norms", "ema_norms"}``."""
        from portbench.reference import training

        m = self.mix
        model = self.reference_model(control)
        cdt = torch.bfloat16 if control else torch.float32
        # a parametrised weight is ``parametrizations.weight.original``
        params = {n.replace(".parametrizations.weight.original", ".weight"): p
                  for n, p in model.named_parameters()
                  if n.startswith("unet.")}
        start = {n: p.detach().clone() for n, p in params.items()}
        opt = training.AdamW(params, lr=m["learning_rate"],
                             betas=tuple(m["betas"]),
                             weight_decay=m["weight_decay"])
        sv_cam = training.dummy_sv_camera(m["image_size"])
        hw = self.latent_hw()
        ema = {n: p.detach().clone() for n, p in params.items()}
        losses, grad_norms = [], None
        for i in range(FOLLOWED):
            batch = self.followed_batch(i)
            g = torch.Generator(device=self.device)
            g.set_state(self.gen_states[i])
            B = batch["images_mv"].shape[0]
            d_mv = training.draw_multi_view(
                g, B, m["views"], hw, drop_pose_p=m["drop_pose_p"],
                drop_text_p=m["drop_text_p"], device=self.device)
            svb = training.sv_batch(batch, sv_cam)
            d_sv = training.draw_multi_view(
                g, svb["images_mv"].shape[0], 1, hw, drop_pose_p=1.0,
                drop_text_p=m["drop_text_p_sv"], device=self.device)
            for p in params.values():
                p.grad = None
            total = 0.0
            rows = m["reference_rows"]
            for lo in self.own_rows(B):
                sl = slice(lo, lo + rows)
                sv_sl = slice(lo * m["images_sv"],
                              (lo + rows) * m["images_sv"])
                loss = training.multi_view_loss(model, batch, d_mv, sl, cdt)
                loss = loss + m["lambda_sv"] * training.multi_view_loss(
                    model, svb, d_sv, sv_sl, cdt)
                loss.backward()
                total += float(loss.detach())
            grads = {n: p.grad.detach().float() for n, p in params.items()}
            losses.append(self.reduce_reference(total, grads))
            training.clip_by_global_norm(grads, m["grad_clip"])
            if i == 0:
                grad_norms = _leaf_norms(grads)
            opt.step(grads)
            with torch.no_grad():
                for n, p in params.items():
                    ema[n].mul_(m["ema_decay"]).add_(
                        p.detach() * (1.0 - m["ema_decay"]))
        change = _leaf_norms({n: p.detach() - start[n]
                              for n, p in params.items()})
        return {"losses": losses, "grad_norms": grad_norms,
                "change_norms": change,
                "ema_norms": _leaf_norms({n: ema[n] - start[n]
                                          for n in params})}

    def numbers(self, control: bool = False) -> dict:
        """The program's (or the control's) distances from the float32
        reference: the largest relative gap of a step's loss, and the
        worst leaf's gap of the first gradient's norm and of the change
        over the three steps. Leaves whose reference gradient is below a
        thousandth of the median leaf's are left out of the change: Adam
        moves them by round-off alone."""
        want = self.follow()
        got = self.follow(control=True) if control else {
            "losses": self.losses, "grad_norms": self.grad_norms,
            "change_norms": self.change_norms, "ema_norms": self.ema_norms}
        med = float(torch.tensor(list(want["grad_norms"].values())).median())
        still = {n for n, v in want["grad_norms"].items() if v < 1e-3 * med}
        return {
            "loss": max(abs(a - b) / abs(b) for a, b in
                        zip(got["losses"], want["losses"])),
            "grad": worst_leaf(got["grad_norms"], want["grad_norms"]),
            "update": worst_leaf(got["change_norms"], want["change_norms"],
                                 still),
            "ema": worst_leaf(got["ema_norms"], want["ema_norms"], still),
            "leaves_left_out": len(still),
        }

    def check(self, limits: dict) -> list:
        got = self.numbers()
        return [(k, got[k], float(limits[k])) for k in self.numbers_compared]
