"""Text to 3D through the legacy GM-LDM, ``GMLDMSystem.sample``: the CLIP
text tower, the Euler sampler with plain CFG over the same multi-view
U-Net, the gaussian-headed VAE decode, ``convert_gaussians``
(``director3d``) and the render, a batch of prompts a unit, each scene with
its own random orbit cameras.

The comparison follows the program step by step from its own state, as in
``t2s_pipeline.py``: the text tower from the benchmark's ids; the U-Net
and the Euler step at two steps drawn from the seed; the VAE decode and
``convert_gaussians`` from the program's final latents; the render from
the program's gaussians.
"""
from __future__ import annotations

import numpy as np
import torch

from portbench import common, weights
from portbench.tokenizer import fixed_tokens

NUMBERS = ("text", "unet", "step", "gaussians", "render")


class Driver:
    work = "scenes"

    def __init__(self, cfg: dict, mix: dict, seed: int, device):
        from prometheus_torch.models import CLIPTextModel, GMLDMModel
        from prometheus_torch.systems import GMLDMSystem

        self.cfg, self.mix, self.seed, self.device = cfg, mix, seed, device
        self.dtype = getattr(torch, cfg["dtype"])
        self.model, self.text = weights.make(
            [(GMLDMModel, cfg["gmldm"]), (CLIPTextModel, cfg["text"])],
            seed, device, self.dtype)
        self.system = GMLDMSystem(self.model)
        self.B = mix["batch"]
        self.prompts = common.PromptStream(seed, self.B)
        rng = np.random.default_rng(common.sub_seed(seed, 2))
        self.compare_units = {0, 1 + int(rng.integers(0, 3))}
        self.compare_steps = sorted(int(s) for s in rng.choice(
            mix["steps"] - 1, size=2, replace=False))
        self.records: dict = {}
        self.timings: list = []
        self.shapes = common.AttentionShapes()
        self._rec = None
        den = self.model.denoise
        want = {k for s in self.compare_steps for k in (s, s + 1)}

        def denoise(inp, txt, t, **kw):
            out = den(inp, txt, t, **kw)
            rec = self._rec
            if rec is not None:
                k = rec["step"]
                rec["step"] = k + 1
                if k in want:
                    rec["unet"][k] = (inp.clone(), txt.clone(), t.clone(),
                                      out.clone())
            return out

        self.model.denoise = denoise

    def _cameras(self, i: int) -> torch.Tensor:
        from portbench.reference.cameras import get_random_cameras

        g = common.generator(self.device, self.seed, 4, i)
        m = self.mix
        return torch.stack([get_random_cameras(
            m["views"], g, size=m["render_size"], device=self.device)
            for _ in range(self.B)])

    def _run(self, i: int):
        from prometheus_torch.pipeline import stage_timer

        m = self.mix
        prompts = self.prompts(i)
        cams = self._cameras(i)
        rec = None
        if i in self.compare_units and i not in self.records:
            rec = self._rec = {"unet": {}, "step": 0, "prompts": prompts,
                               "cameras": cams}
        timings = {}
        mark = stage_timer(self.device, timings)
        ids = torch.from_numpy(fixed_tokens(prompts + [""])).to(self.device)
        with torch.no_grad():
            emb = self.text(ids)
        txt = emb[:self.B]
        unc = emb[self.B:].expand(txt.shape).contiguous()
        mark("encode_text")
        out = self.system.sample(
            cams, txt, unc, generator=common.generator(
                self.device, self.seed, 3, i),
            num_inference_steps=m["steps"],
            guidance_scale=m["guidance_scale"], latent_hw=m["latent_hw"],
            render_size=m["render_size"], mark=mark)
        self._rec = None
        if rec is not None:
            rec.update(text=emb.clone(), ids=ids,
                       **{k: out[k] for k in ("latents_pred", "gaussians",
                                              "images_gs_render")})
            self.records[i] = rec
        out["timings"] = timings
        return out

    def warmup(self):
        """One unit at the window's shapes; not compared, not counted."""
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
        """The text tower on the batch and the empty prompt, the U-Net on
        the CFG-stacked batch at each step, and the VAE decode, counted on
        the plain reference on the meta device."""
        from portbench.reference import clip_text, gm_ldm

        cfg, m, B = self.cfg, self.mix, self.B
        N, hw = m["views"], m["latent_hw"]
        with torch.device("meta"):
            gm = gm_ldm.GMLDMModel(**cfg["gmldm"])
            tx = clip_text.CLIPTextModel(**cfg["text"])
            text = common.meta_flops(lambda: tx(
                torch.zeros(B + 1, 77, dtype=torch.long)))
            unet = common.meta_flops(lambda: gm.denoise(
                torch.zeros(2 * B, N, 10, hw, hw),
                torch.zeros(2 * B, 77, cfg["gmldm"]["context_dim"]),
                torch.zeros(2 * B, N)))
            dec = common.meta_flops(lambda: gm.decode_raw(
                torch.zeros(B, N, 4, hw, hw), torch.zeros(B, N, 6, hw, hw)))
        return text + m["steps"] * unet + dec

    def release(self):
        del self.model, self.text, self.system
        self.model = self.text = self.system = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, control: bool = False):
        from portbench.reference import clip_text, gm_ldm
        from portbench.reference.precision import fp8_

        mods = weights.make(
            [(gm_ldm.GMLDMModel, self.cfg["gmldm"]),
             (clip_text.CLIPTextModel, self.cfg["text"])], self.seed,
            self.device, self.dtype)
        return [fp8_(m) if control else m.float() for m in mods]

    @torch.no_grad()
    def numbers(self, control: bool = False) -> dict:
        from portbench.reference import converter, rays, render, sampling

        ref = self.reference()
        ctl = self.reference(control=True) if control else None
        m, out = self.mix, {k: 0.0 for k in NUMBERS}
        sig = sampling.VPRED.inference_sigmas(m["steps"]).to(self.device)
        c_in = sampling.VPRED.c_in
        for rec in self.records.values():
            B = len(rec["prompts"])
            want = ref[1](rec["ids"])
            got = ctl[1](rec["ids"]) if control else rec["text"]
            out["text"] = max(out["text"], common.rel_max(got, want))
            for k in self.compare_steps:
                inp, txt, t, o = rec["unet"][k]
                inp1 = rec["unet"][k + 1][0]
                want = ref[0].denoise(inp.float(), txt.float(), t.float())
                got = ctl[0].denoise(inp, txt, t).float() if control \
                    else o.float()
                out["unet"] = max(out["unet"], common.rel_max(got, want))
                # the sampler's step from the program's own output: plain
                # CFG, x0, Euler
                x = inp[:B, :, :4].float() / c_in(sig[k])
                _, x_w = sampling.euler_from_output(
                    x, sampling.plain_cfg(o.float(), m["guidance_scale"]),
                    sig[k], sig[k + 1])
                if control:
                    b16 = torch.bfloat16
                    x_g = sampling.euler_from_output(
                        x.to(b16), sampling.plain_cfg(
                            o.to(b16), m["guidance_scale"]),
                        sig[k], sig[k + 1])[1].float()
                else:
                    x_g = inp1[:B, :, :4].float() / c_in(sig[k + 1])
                out["step"] = max(out["step"],
                                  common.rel_max(x_g - x, x_w - x))
            lat, cams = rec["latents_pred"].float(), rec["cameras"].float()
            rm = rays.raymap(cams, *lat.shape[-2:])

            def decode(mod, lat=lat, rm=rm, cams=cams):
                dt = next(mod.parameters()).dtype
                raw = mod.decode_raw(lat.to(dt), rm.to(dt))
                return converter.convert_gaussians(raw.float(), cams,
                                                   mode="director3d")

            want = decode(ref[0])
            got = decode(ctl[0]) if control else rec["gaussians"]
            out["gaussians"] = max(out["gaussians"], max(
                common.rel_rms(a, b) for a, b in zip(got, want)))
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
