"""The command-line entries: the ScanNet benchmark's (``python -m
tpu3dsis_torch.tools.vox2mesh | proj_label | evaluate_benchmark |
export_gt``, the arguments of the root ``tools/`` scripts of those names),
the PLY views (``visualize``, ``visualize_benchmark``), the synthetic demo
(``demo``) and the closed color loop (``color_loop``); ``ply`` and
``visualization`` are the modules they use."""
