"""Small widths and sizes of each cell for the CPU tests: the cells'
configurations and traffic with the networks narrowed and the batch,
views, steps and images cut, so that a whole run fits a test."""
from __future__ import annotations

from portbench import manifest as mf

SMALL = {
    "prometheus": dict(
        mvldm=dict(model_channels=64, num_head_channels=32, context_dim=64,
                   channel_mult=[1, 2], num_res_blocks=1,
                   disable_3d_attentions=[1, 0, 0, 0, 0], clip_layers=2,
                   clip_width=64, vae_ch=32, vae_ch_mult=[1, 2, 4],
                   image_size=64),
        gsdecoder=dict(dit_hidden_size=64, dit_depth=2, dit_num_heads=4,
                       vae_ch=32, vae_ch_mult=[1, 2, 4]),
        traj=dict(hidden_size=64, num_blocks=2, num_heads=4, text_dim=64)),
    "gmldm": dict(
        gmldm=dict(model_channels=64, num_head_channels=32, context_dim=64,
                   channel_mult=[1, 2], num_res_blocks=1, vae_ch=32,
                   vae_ch_mult=[1, 2, 4], image_size=64),
        text=dict(width=64, num_heads=4, num_layers=2)),
}
SMALL_MIX = {
    "t2s_b4": dict(batch=2, views=2, steps=4, render_size=64),
    "t2s_b4_orbitcams": dict(batch=2, views=2, steps=4, render_size=64,
                             latent_hw=16),
    "orbit_512": dict(gaussians=4096, size=64, frames=16, scenes=2,
                      compare_frames=3),
    "train_s2_b8": dict(batch=2, views=2, images_sv=1, image_size=64, pool=3,
                        reference_rows=1),
    "train_s2_dp4": dict(batch=2, views=2, images_sv=1, image_size=64,
                         pool=3, reference_rows=1),
}


# every cell the drivers serve, with those ``BENCHMARK.json`` does not list
# yet (the orbit: PERF.md, Open questions)
CELLS = {"prometheus.t2s_b4": ("prometheus", "t2s_b4"),
         "gmldm.t2s_b4": ("gmldm", "t2s_b4_orbitcams"),
         "prometheus.train_s2_b8": ("prometheus", "train_s2_b8"),
         "prometheus.train_s2_dp4": ("prometheus", "train_s2_dp4"),
         "prometheus.orbit_512": ("prometheus", "orbit_512")}


def cell(name: str):
    """``(cfg, mix)`` of a cell at the small sizes."""
    config, traffic = CELLS[name]
    cfg = mf.config(config)
    cfg.update(SMALL[config])
    mix = mf.traffic(traffic)
    mix.update(SMALL_MIX[traffic])
    return cfg, mix


def manifest_with(name: str) -> dict:
    """``BENCHMARK.json`` with ``name`` among its cells (listed or not)."""
    man = mf.manifest()
    if not any(w["name"] == name for w in man["workloads"]):
        config, traffic = CELLS[name]
        man["workloads"] = man["workloads"] + [
            {"name": name, "config": config, "traffic": traffic,
             "chips": 1, "why": "not listed yet"}]
        man["end_to_end"] = man["end_to_end"] + [
            {"name": "render_fps", "unit": "frames/s", "better": "higher",
             "bound": 0.25, "source": "host_clock", "workloads": [name]}]
    return man
