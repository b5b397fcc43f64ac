"""Several cards: the multi-process runtime (``distributed``), the X-sharded
backbone (``spatial``) and the single-shot scene over it (``scene``)
(``tpu3dsis/parallel``)."""

from tpu3dsis_torch.parallel.spatial import halo_exchange, spatial_features

__all__ = ["halo_exchange", "spatial_features"]
