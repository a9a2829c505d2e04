"""Faults planted in the program underneath a run, to show that the output
check catches them: the tests run them on the CPU at small sizes, and
``calibrate.py --fault`` reads them on the card at a cell's own size.

- ``step_unchanged``: the step returns its state unchanged (the sampler's
  Euler step; the training step's optimizer);
- ``half_batch``: half of the batch left out (the sampler: the network's
  rows of one half copied from the other; training: the loss's mean over
  one half of the scenes; the orbit: the second half of the frames copied
  from the first);
- ``altered``: an answer altered where it is produced (the rendered
  images or frames, by 0.05);
- ``exchange_left_out``: training over ranks, every rank takes part in the
  gradient all-reduce and keeps its own gradient (no rank's update sees
  the others' batches);
- ``rank_skips_reduce``: the same on the last rank alone (its parameters
  leave the others').

A single card has no exchange between chips to leave out: there the last
two change nothing.
"""
from __future__ import annotations


def _altered_render(render):
    def altered(*a, **kw):
        imgs, deps, masks = render(*a, **kw)
        return imgs + 0.05, deps, masks

    return altered


def step_unchanged(drv):
    if hasattr(drv, "trainer"):
        drv.trainer.state.optimizer.step = lambda closure=None: None
        return
    system = drv.pipe.mvldm if hasattr(drv, "pipe") else drv.system

    class Unchanged:
        """The system's (frozen) schedule with an Euler step that returns
        its state."""

        def __init__(self, schedule):
            self._schedule = schedule

        def __getattr__(self, name):
            return getattr(self._schedule, name)

        def euler_step(self, x_t, x0, sigma, sigma_next):
            return x_t

    system.schedule = Unchanged(system.schedule)


def half_batch(drv):
    if hasattr(drv, "trainer"):
        loss_fn = drv.trainer.loss_fn

        def half(batch):
            n = batch["images_mv"].shape[0] // 2
            return loss_fn({k: v[:n] for k, v in batch.items()})

        drv.trainer.loss_fn = half
        return
    if hasattr(drv, "scenes"):
        render = drv.pipe.render_orbit_video

        def half_frames(*a, **kw):
            frames = render(*a, **kw).clone()
            n = frames.shape[0] // 2
            frames[n:2 * n] = frames[:n]
            return frames

        drv.pipe.render_orbit_video = half_frames
        return
    model = drv.pipe.mvldm.model if hasattr(drv, "pipe") else drv.model
    den = model.denoise

    def denoise(inp, ctx, t, **kw):
        out = den(inp, ctx, t, **kw).clone()
        B = out.shape[0] // 2            # the cond rows, then the uncond rows
        for r0 in (0, B):
            out[r0 + B // 2:r0 + B] = out[r0:r0 + B // 2]
        return out

    model.denoise = denoise


def altered(drv):
    if hasattr(drv, "scenes"):
        render = drv.pipe.render_orbit_video
        drv.pipe.render_orbit_video = lambda *a, **kw: render(*a, **kw) + 0.05
    elif hasattr(drv, "pipe"):
        drv.pipe.render_views_chunked = _altered_render(
            drv.pipe.render_views_chunked)
    else:
        from prometheus_torch.systems import gm_ldm_system

        drv.restore = (gm_ldm_system, gm_ldm_system.render_gaussians)
        gm_ldm_system.render_gaussians = _altered_render(
            gm_ldm_system.render_gaussians)


def exchange_left_out(drv):
    """The train step's all-reduce of the gradients still runs, on copies,
    and the step goes on with this rank's own gradients."""
    from prometheus_torch.parallel import train_step

    reduce, n = train_step.all_reduce_, len(drv._trained())

    def kept(tensors, group=None):
        if len(tensors) == n:
            tensors = [t.clone() for t in tensors]
        reduce(tensors, group)

    train_step.all_reduce_ = kept


def rank_skips_reduce(drv):
    import torch.distributed as dist

    if dist.is_initialized() and \
            dist.get_rank() == dist.get_world_size() - 1:
        exchange_left_out(drv)


FAULTS = {"step_unchanged": step_unchanged, "half_batch": half_batch,
          "altered": altered, "exchange_left_out": exchange_left_out,
          "rank_skips_reduce": rank_skips_reduce}
