"""Command-line tools of the port (``python -m
prometheus_torch.tools.<name>``), each the counterpart of the repo's
``tools/<name>.py`` with its arguments and files:

- weights: ``create_final_ckpt`` bundles trained stage checkpoints into a
  release bundle, ``convert_ckpt`` converts a published ``full.ckpt``;
- data: ``build_metadata`` (annotation files of every dataset layout),
  ``make_synthetic_scenes``, ``generate_captions``, ``generate_depths``
  (DA2 teacher depths), ``dataset_gallery``, ``test_dataloader`` (the
  counterpart of ``scripts/test_dataloader.py``) and ``bench_loader``
  (the native data plane against the Python path);
- evaluation and figures: ``stage1_eval``, ``compute_metrics`` (BRISQUE,
  NIQE, CLIP over galleries), ``view_scene`` (a standalone HTML viewer),
  ``paper_figures``;
- measurement: ``raster_profile`` (the render by stage),
  ``profile_train_step`` (the stage-2 step by section), ``parse_trace``
  (the top ops of a ``profiling.trace``), and the studies
  ``sampler_quality_study``, ``e2e_quality_study`` and
  ``refine_width_study``.
"""
