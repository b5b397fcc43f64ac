from tpu3dsis_torch.io.chunk_format import RawChunk, read_chunk_file, write_chunk_file
from tpu3dsis_torch.io.dataset import Sample, SceneDataset, encode_tsdf, pad_sample, paint_mask_canvas

__all__ = ["RawChunk", "Sample", "SceneDataset", "encode_tsdf", "pad_sample", "paint_mask_canvas",
           "read_chunk_file", "write_chunk_file"]
