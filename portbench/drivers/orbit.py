"""The CLI's orbit video through ``PrometheusPipeline.render_orbit_video``:
a scene's trajectory slerp-resampled to the video's frames, rendered a
chunk of frames a compositor launch (projection, csort binning, kernel B)
and copied to the host, one video a unit.

Scenes with a trained model's statistics are made in set-up, one for each
of the traffic's orbit distances and elevations; each video takes the next
scene and a new 29-camera arc of its orbit (span and direction from the
seed, the span from the traffic's range). The
comparison renders frames drawn from the seed, of the compared videos, with
the plain reference renderer and holds the program's frames to them.
"""
from __future__ import annotations

import numpy as np
import torch

from portbench import common, scenes

NUMBERS = ("render",)


class Driver:
    work = "frames"

    def __init__(self, cfg: dict, mix: dict, seed: int, device):
        from prometheus_torch.pipeline import PrometheusPipeline

        from portbench.tokenizer import fixed_tokens

        self.cfg, self.mix, self.seed, self.device = cfg, mix, seed, device
        # the renderer alone: no networks
        self.pipe = PrometheusPipeline(mvldm=None, gsdecoder=None,
                                       tokenizer=fixed_tokens)
        g = common.generator(device, seed, 5)
        size = mix["size"]
        self.scenes, self.bases = [], []
        # the scenes' distances and elevations are the traffic's, the same
        # for every seed (they set the work); the seed draws the azimuths
        # and every gaussian
        for radius, elev in mix["orbits"][:mix["scenes"]]:
            azim = 360.0 * float(torch.rand(1, generator=g, device=device))
            base = (radius, elev, azim)
            cam = scenes.orbit_camera(*base, size, device=device)
            self.scenes.append(scenes.make_trained_stats_scene(
                cam, g, n_gaussians=mix["gaussians"]))
            self.bases.append(base)
        rng = np.random.default_rng(common.sub_seed(seed, 2))
        self.compare_units = {0, 1 + int(rng.integers(0, 3))}
        self.compare_frames = sorted(int(f) for f in rng.choice(
            mix["frames"], size=mix["compare_frames"], replace=False))
        self.records: dict = {}
        self.timings: list = []

    def _dense(self, i: int) -> torch.Tensor:
        g = common.generator(self.device, self.seed, 6, i)
        return scenes.orbit_arc(self.bases[i % len(self.bases)], g,
                                self.mix["size"], span=self.mix["span"])

    def _run(self, i: int):
        m = self.mix
        dense = self._dense(i)
        gaussians = self.scenes[i % len(self.scenes)]
        frames = self.pipe.render_orbit_video(
            gaussians, dense, num_frames=m["frames"], size=m["size"],
            chunk=m["chunk"], tile_capacity=m["tile_capacity"])
        if i in self.compare_units and i not in self.records:
            self.records[i] = {"dense": dense, "scene": i % len(self.scenes),
                               "frames": frames[self.compare_frames]}
        return frames

    def warmup(self):
        """One video at the window's shapes; not compared, not counted."""
        self.unit(-1)

    def record(self):
        """The compared units alone, without a window (calibration)."""
        for i in sorted(self.compare_units):
            self._run(i)

    def unit(self, i: int):
        frames = self._run(i)
        # the frames are on the host: one sum, not a pass over every value
        return frames.shape[0], torch.isfinite(frames.sum())

    def end_to_end(self, units: int, work: int, window_s: float) -> dict:
        return {"render_fps": work / window_s}

    def trace_on(self):
        pass

    def trace_off(self):
        pass

    def _frame_cameras(self, dense: torch.Tensor, idx: list) -> torch.Tensor:
        from portbench.reference.cameras import sample_from_dense_cameras

        t = torch.linspace(0, 1, self.mix["frames"],
                           device=dense.device)[None]
        return sample_from_dense_cameras(dense[:1].float(), t)[:, idx]

    @torch.no_grad()
    def kept_pairs_per_video(self) -> float | None:
        """The (gaussian, pixel) pairs a video's frames keep, counted by
        the reference's projection and alpha test on every ``chunk``-th
        frame of the compared videos, times ``chunk``."""
        from portbench.reference import render

        m, counts = self.mix, []
        idx = list(range(0, m["frames"], m["chunk"]))
        for i in self.records:
            cams = self._frame_cameras(self._dense(i), idx)[0]
            xyz, feats, op, sc, rot = (t[0] for t in
                                       self.scenes[i % len(self.scenes)])
            kept = sum(float(render.render_view(
                c, xyz, feats[:, 0], op[:, 0], sc, rot, m["size"],
                m["size"], m["tile_capacity"])[3].sum()) for c in cams)
            counts.append(kept * m["chunk"])
        return sum(counts) / len(counts) if counts else None

    def layer_context(self) -> dict:
        pairs = self.kept_pairs_per_video()
        return {"timings": self.timings, "kept_pairs_per_unit": pairs}

    def release(self):
        """The scenes stay: the reference renders them."""
        self.pipe = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    @torch.no_grad()
    def numbers(self, control: bool = False) -> dict:
        """The RMS gap of the program's (or, with ``control``, the bf16
        reference's) frames to the float32 reference's, over the compared
        frames of the compared videos."""
        from portbench.reference import render

        m, worst = self.mix, 0.0
        dt = torch.bfloat16 if control else torch.float32
        for i, rec in self.records.items():
            cams = self._frame_cameras(rec["dense"], self.compare_frames)[0]
            xyz, feats, op, sc, rot = (t[0] for t in self.scenes[rec["scene"]])
            for j, c in enumerate(cams):
                args = (c, xyz, feats[:, 0], op[:, 0], sc, rot, m["size"],
                        m["size"], m["tile_capacity"])
                want = render.render_view(*args)[0]
                got = (render.render_view(*args, dtype=dt)[0] if control
                       else rec["frames"][j].to(want.device))
                worst = max(worst, common.rms(got, want))
        return {"render": worst}

    def check(self, limits: dict) -> list:
        got = self.numbers()
        return [(k, got[k], float(limits[k])) for k in NUMBERS]
