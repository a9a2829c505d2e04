"""Text to 3D through ``prometheus_torch.serve.generate_batch``: CLIP text,
TrajDiT's DDIM trajectory, the MV-LDM sampler (joint CFG with rescale,
Euler), the GS decoder, ``convert_gaussians`` and the render, a batch of
prompts a unit, no exports.

The comparison follows the program step by step from its own state: the
text tower from the benchmark's token ids; TrajDiT and its DDIM update,
and the U-Net and the sampler's Euler step, each at two steps drawn from
the seed, from the program's own inputs to them; the GS decoder and ``convert_gaussians`` from the
program's final latents and cameras; the render from the program's
gaussians. Each number is the program's distance from the plain float32
reference (``reference/``) on the same inputs.
"""
from __future__ import annotations

import numpy as np
import torch

from portbench import common, weights
from portbench.tokenizer import fixed_tokens

NUMBERS = ("text", "traj", "traj_step", "unet", "step", "gaussians", "render")


def _traj_head_(traj, token: torch.Tensor) -> None:
    """The random TrajDiT's output layer, scaled by 0.1 and centred on a
    default camera's token (as ``pipeline.build_pipeline`` does), so that
    the random trajectory's cameras stay clear of the token guards."""
    with torch.no_grad():
        traj.out_block.weight.mul_(0.1)
        traj.out_block.bias.copy_(token.to(traj.out_block.bias))


class Driver:
    work = "scenes"

    def __init__(self, cfg: dict, mix: dict, seed: int, device):
        from prometheus_torch.models import (GSDecoderModel, MVLDMModel,
                                             TrajDiTModel)
        from prometheus_torch.pipeline import PrometheusPipeline
        from prometheus_torch.systems import MVLDMSystem, TrajDiTSystem

        from portbench.reference.sampling import default_camera_token

        self.cfg, self.mix, self.seed, self.device = cfg, mix, seed, device
        self.dtype = getattr(torch, cfg["dtype"])
        mv, gs, traj = weights.make(
            [(MVLDMModel, cfg["mvldm"]), (GSDecoderModel, cfg["gsdecoder"]),
             (TrajDiTModel, cfg["traj"])], seed, device, self.dtype)
        _traj_head_(traj, default_camera_token())
        self.pipe = PrometheusPipeline(
            mvldm=MVLDMSystem(model=mv), gsdecoder=gs,
            traj=TrajDiTSystem(model=traj), tokenizer=fixed_tokens,
            gs_kwargs=dict(cfg["gs_kwargs"]))
        self.B = mix["batch"]
        self.prompts = common.PromptStream(seed, self.B)
        rng = np.random.default_rng(common.sub_seed(seed, 2))
        # the units compared: the first and one of the next three; the
        # U-Net steps compared in them (each with the step after it)
        self.compare_units = {0, 1 + int(rng.integers(0, 3))}
        steps = mix["steps"]
        self.compare_steps = sorted(int(s) for s in rng.choice(
            steps - 1, size=2, replace=False))
        self.compare_traj_steps = sorted(int(s) for s in rng.choice(
            mix["traj_steps"] - 1, size=2, replace=False))
        self.records: dict = {}
        self.timings: list = []
        self.shapes = common.AttentionShapes()
        self._rec = None
        self._hook()

    # -- the window ------------------------------------------------------
    def _hook(self):
        pipe, model = self.pipe, self.pipe.mvldm.model
        enc, den = pipe.encode_text, model.denoise
        want = {k for s in self.compare_steps for k in (s, s + 1)}
        want_traj = {k for s in self.compare_traj_steps for k in (s, s + 1)}
        driver = self

        class TrajRecorder:
            """TrajDiT's module, its calls recorded at the compared
            steps."""

            def __init__(self, module):
                self.module = module

            def __getattr__(self, name):
                return getattr(self.module, name)

            def __call__(self, x, text, t):
                out = self.module(x, text, t)
                rec = driver._rec
                if rec is not None:
                    k = rec["traj_step"]
                    rec["traj_step"] = k + 1
                    if k in want_traj:
                        rec["traj"][k] = (x.clone(), text.clone(), t.clone(),
                                          out.clone())
                return out

        def hidden(_mod, args):
            rec = driver._rec
            if rec is not None and rec["traj_step"] in want_traj:
                rec["traj_hidden"][rec["traj_step"]] = args[0].clone()

        pipe.traj.model.out_block.register_forward_pre_hook(hidden)
        pipe.traj.model = TrajRecorder(pipe.traj.model)

        def encode_text(texts):
            out = enc(texts)
            if self._rec is not None:
                self._rec["text"].append((list(texts), out.clone()))
            return out

        def denoise(inp, ctx, t, **kw):
            out = den(inp, ctx, t, **kw)
            rec = self._rec
            if rec is not None:
                k = rec["step"]
                rec["step"] = k + 1
                if k in want:
                    rec["unet"][k] = (inp.clone(), ctx.clone(), t.clone(),
                                      out.clone())
            return out

        pipe.encode_text, model.denoise = encode_text, denoise

    def _inputs(self, i: int):
        g = common.generator(self.device, self.seed, 3, i)
        B, m = self.B, self.mix
        hw = self.pipe.mvldm.model.latent_size
        traj_noise = torch.randn((B, 29, 11), generator=g,
                                 device=self.device)
        noise = torch.randn((B, m["views"], 8, hw, hw), generator=g,
                            device=self.device)
        return traj_noise, noise

    def _run(self, i: int):
        from prometheus_torch import serve

        m = self.mix
        traj_noise, noise = self._inputs(i)
        prompts = self.prompts(i)
        rec = None
        if i in self.compare_units and i not in self.records:
            rec = self._rec = {"text": [], "unet": {}, "step": 0,
                               "traj": {}, "traj_step": 0,
                               "traj_hidden": {},
                               "prompts": prompts, "traj_noise": traj_noise}
        out = serve.generate_batch(
            self.pipe, prompts, None, num_views=m["views"],
            num_inference_steps=m["steps"],
            guidance_scale=m["guidance_scale"], cfg_rescale=m["cfg_rescale"],
            render_size=m["render_size"], image_size=m["traj_image_size"],
            traj_noise=traj_noise, noise=noise)
        self._rec = None
        if rec is not None:
            rec.update({k: out[k] for k in ("dense_cameras", "cameras",
                                            "latents_pred", "gaussians",
                                            "images_gs_render")})
            self.records[i] = rec
        return out

    def warmup(self):
        """One unit at the window's shapes (builds and loads the kernels);
        not compared, not counted."""
        self.unit(-1)
        self.timings.clear()

    def record(self):
        """The compared units alone, without a window (calibration)."""
        for i in sorted(self.compare_units):
            self._run(i)

    def unit(self, i: int):
        out = self._run(i)
        self.timings.append(out["timings"])
        return self.B, common.finite(out["images_gs_render"],
                                     *out["gaussians"])

    def end_to_end(self, units: int, work: int, window_s: float) -> dict:
        return {"scenes_per_min": 60.0 * work / window_s}

    def trace_on(self):
        self.shapes.on()

    def trace_off(self):
        self.shapes.off()

    def layer_context(self) -> dict:
        return {"timings": self.timings, "attn_fwd": self.shapes.fwd,
                "attn_bwd": self.shapes.bwd,
                "flops_per_unit": self.flops_per_unit()}

    def flops_per_unit(self) -> float:
        """The model FLOPs of one unit, counted on the plain reference at
        the unit's shapes on the meta device: the text tower on the batch
        and the empty prompt, TrajDiT at each DDIM step, the U-Net on the
        CFG-stacked batch at each sampler step, and the GS decoder."""
        from portbench.reference import gs_decoder, mv_ldm, traj_dit

        cfg, m, B = self.cfg, self.mix, self.B
        N = m["views"]
        with torch.device("meta"):
            mv = mv_ldm.MVLDMModel(**cfg["mvldm"])
            gs = gs_decoder.GSDecoderModel(**cfg["gsdecoder"])
            tj = traj_dit.TrajDiTModel(**cfg["traj"])
            hw, L = mv.latent_size, 77
            ids = torch.zeros(B + 1, L, dtype=torch.long)
            ctx = torch.zeros(2 * B, L, mv.context_dim)
            inp = torch.zeros(2 * B, N, 15, hw, hw)
            t = torch.zeros(2 * B, N)
            text = common.meta_flops(lambda: mv.encode_text(ids))
            unet = common.meta_flops(lambda: mv.denoise(inp, ctx, t))
            trj = common.meta_flops(lambda: tj(
                torch.zeros(B, 29, 11), torch.zeros(B, L, mv.context_dim),
                torch.zeros(B)))
            dec = common.meta_flops(lambda: gs.decode_latent(
                torch.zeros(B, N, 14, hw, hw)))
        return text + m["traj_steps"] * trj + m["steps"] * unet + dec

    def release(self):
        del self.pipe
        self.pipe = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the comparison ----------------------------------------------------
    def reference(self, control: bool = False):
        """The plain reference's modules at float32 from the same seed, or,
        with ``control``, the same modules one precision step below the
        configuration's bf16: fp8 (``reference/precision.py``)."""
        from portbench.reference import gs_decoder, mv_ldm, traj_dit
        from portbench.reference.precision import fp8_
        from portbench.reference.sampling import default_camera_token

        cfg = self.cfg
        mods = weights.make(
            [(mv_ldm.MVLDMModel, cfg["mvldm"]),
             (gs_decoder.GSDecoderModel, cfg["gsdecoder"]),
             (traj_dit.TrajDiTModel, cfg["traj"])], self.seed, self.device,
            self.dtype)
        _traj_head_(mods[2], default_camera_token())
        return [fp8_(m) if control else m.float() for m in mods]

    @torch.no_grad()
    def numbers(self, control: bool = False) -> dict:
        """Each compared number, the largest over the compared units: the
        program's (or, with ``control``, the fp8 control's) distance from
        the float32 reference on the same inputs."""
        from portbench.reference import converter, rays, render, sampling

        ref = self.reference()
        ctl = self.reference(control=True) if control else None
        m, out = self.mix, {k: 0.0 for k in NUMBERS}
        sig = sampling.VPRED.inference_sigmas(m["steps"]).to(self.device)
        c_in = sampling.VPRED.c_in
        for rec in self.records.values():
            B = len(rec["prompts"])
            # the text tower, from the benchmark's ids
            for texts, emb in rec["text"]:
                ids = torch.from_numpy(fixed_tokens(texts)).to(self.device)
                want = ref[0].encode_text(ids)
                got = ctl[0].encode_text(ids) if control else emb
                out["text"] = max(out["text"], common.rel_max(got, want))
            # TrajDiT: its blocks' output (the output layer's input), and
            # the DDIM update from the program's own prediction
            for k in self.compare_traj_steps:
                x, txt, t, o = rec["traj"][k]
                h_prog = rec["traj_hidden"][k]
                seen = {}
                hook = ref[2].out_block.register_forward_pre_hook(
                    lambda _m, a: seen.__setitem__("h", a[0]))
                ref[2](x, txt.float(), t)
                hook.remove()
                want_h = seen["h"]
                if control:
                    hook = ctl[2].out_block.register_forward_pre_hook(
                        lambda _m, a: seen.__setitem__("h", a[0]))
                    ctl[2](x, txt, t)
                    hook.remove()
                    got_h = seen["h"].float()
                else:
                    got_h = h_prog.float()
                out["traj"] = max(out["traj"], common.rel_max(got_h, want_h))
                dt = torch.bfloat16 if control else torch.float32
                x_w = sampling.traj_step(x, o, k, m["traj_steps"])
                x_g = (sampling.traj_step(x, o, k, m["traj_steps"], dt)
                       if control else rec["traj"][k + 1][0])
                out["traj_step"] = max(out["traj_step"], common.rel_max(
                    x_g.float() - x, x_w - x))
            # the U-Net, and the sampler's step from step k to k + 1
            for k in self.compare_steps:
                inp, ctx, t, o = rec["unet"][k]
                inp1 = rec["unet"][k + 1][0]
                want = ref[0].denoise(inp.float(), ctx.float(), t.float())
                got = ctl[0].denoise(inp, ctx, t).float() if control \
                    else o.float()
                out["unet"] = max(out["unet"], common.rel_max(got, want))
                # the sampler's step from the program's own output: joint
                # CFG with the rescale, x0, Euler
                x = inp[:B, :, :8].float() / c_in(sig[k])
                _, x_w = sampling.euler_from_output(
                    x, sampling.joint_cfg(o.float(), m["guidance_scale"],
                                          m["cfg_rescale"]), sig[k],
                    sig[k + 1])
                if control:
                    b16 = torch.bfloat16
                    x_g = sampling.euler_from_output(
                        x.to(b16), sampling.joint_cfg(
                            o.to(b16), m["guidance_scale"], m["cfg_rescale"]),
                        sig[k], sig[k + 1])[1].float()
                else:
                    x_g = inp1[:B, :, :8].float() / c_in(sig[k + 1])
                out["step"] = max(out["step"],
                                  common.rel_max(x_g - x, x_w - x))
            # the GS decoder and convert_gaussians
            lat, cams = rec["latents_pred"].float(), rec["cameras"].float()
            h, w = lat.shape[-2:]
            z = torch.cat([lat, rays.raymap(cams, h, w)], dim=2)

            def decode(mod, z=z, cams=cams):
                raw = mod.decode_latent(z.to(next(mod.parameters()).dtype))
                return converter.convert_gaussians(raw.float(), cams,
                                                   **self.cfg["gs_kwargs"])

            want = decode(ref[1])
            got = decode(ctl[1]) if control else rec["gaussians"]
            out["gaussians"] = max(out["gaussians"], max(
                common.rel_rms(a, b) for a, b in zip(got, want)))
            # the render of the program's gaussians
            size, cap = m["render_size"], m["tile_capacity"]
            want = render.render(cams, rec["gaussians"], size, size, cap)[0]
            got = (render.render(cams, rec["gaussians"], size, size, cap,
                                 dtype=torch.bfloat16)[0] if control
                   else rec["images_gs_render"])
            out["render"] = max(out["render"], common.rms(got, want))
        return out

    def check(self, limits: dict) -> list:
        got = self.numbers()
        return [(k, got[k], float(limits[k])) for k in NUMBERS]
