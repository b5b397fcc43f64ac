from tpu3dsis_torch.io.chunk_format import RawChunk, read_chunk_file, write_chunk_file
from tpu3dsis_torch.io.dataset import Sample, SceneDataset, encode_tsdf

__all__ = ["RawChunk", "Sample", "SceneDataset", "encode_tsdf", "read_chunk_file", "write_chunk_file"]
