"""The ScanNet benchmark's command-line entries (``python -m
tpu3dsis_torch.tools.vox2mesh | proj_label | evaluate_benchmark |
export_gt``, the arguments of the root ``tools/`` scripts of those names)
and ``ply``, the mesh reader they use."""
