// Host runtime: .chunk/.scene decode and the fused TSDF encode, in one pass.
//
// A copy of the JAX package's tpu3dsis/runtime/chunk_decoder.cpp. The
// training loader decodes a chunk per sample: the per-field struct reader
// plus numpy's reshape, clip, abs and occupancy passes cost the host time a
// step must hide. This library does one pass over the file's bytes:
//   - parses the saveChunkToFile layout (datagen/SceneSampler/main.cpp:348-394)
//   - emits the 2-channel encoded TSDF (clip/abs [+flip/log] + occupancy)
//     directly in channels-last (X, Y, Z, 2) C-order, converting from the
//     file's Fortran order in the same sweep
//   - returns boxes/labels/fractions and paints the binary mask canvas
// Exposed through a C ABI bound with ctypes (tpu3dsis_torch/runtime/native.py),
// built with g++ by tpu3dsis_torch/_build.py::build_host.

#include <cstdint>
#include <cstring>
#include <cstdio>
#include <cstdlib>
#include <cmath>
#include <vector>

extern "C" {

struct ChunkHeader {
  uint64_t dim_x, dim_y, dim_z;
  uint32_t num_boxes;
  uint32_t num_masks;
  uint32_t num_images;
};

// Parse only the header/counts so the caller can allocate. Returns 0 on
// success, negative error codes on malformed input.
int chunk_peek(const uint8_t* buf, uint64_t len, ChunkHeader* out) {
  if (len < 24) return -1;
  uint64_t off = 0;
  std::memcpy(&out->dim_x, buf + off, 8); off += 8;
  std::memcpy(&out->dim_y, buf + off, 8); off += 8;
  std::memcpy(&out->dim_z, buf + off, 8); off += 8;
  uint64_t n = out->dim_x * out->dim_y * out->dim_z;
  off += n * 4;
  if (off + 4 > len) return -2;
  std::memcpy(&out->num_boxes, buf + off, 4); off += 4;
  off += (uint64_t)out->num_boxes * (6 * 4 + 4);
  if (off + 4 > len) return -3;
  std::memcpy(&out->num_masks, buf + off, 4); off += 4;
  for (uint32_t i = 0; i < out->num_masks; i++) {
    off += 4;  // label
    if (off + 24 > len) return -4;
    uint64_t mx, my, mz;
    std::memcpy(&mx, buf + off, 8); off += 8;
    std::memcpy(&my, buf + off, 8); off += 8;
    std::memcpy(&mz, buf + off, 8); off += 8;
    off += mx * my * mz * 2;
  }
  if (off + 4 > len) return -5;
  uint32_t nb2;
  std::memcpy(&nb2, buf + off, 4); off += 4;
  off += (uint64_t)nb2 * 4;  // fractions
  off += 16 * 4;             // world2chunk
  if (off + 4 > len) return -6;
  std::memcpy(&out->num_images, buf + off, 4); off += 4;
  off += (uint64_t)out->num_images * 4;
  if (off > len) return -7;
  return 0;
}

// Full decode. Output buffers are caller-allocated per chunk_peek:
//   data:      (dimX, dimY, dimZ, 2) float32 C-order, encoded TSDF
//   boxes:     (num_boxes, 6) float32 (raw, un-rounded)
//   labels:    (num_boxes,) uint32
//   fractions: (num_boxes,) float32
//   world2chunk: 16 float32 (raw file matrix, row-major)
//   frame_ids: (num_images,) uint32
//   mask_canvas: (dimX, dimY, dimZ) float32 — binary union of instance
//     masks painted at FLOOR/CEIL box bounds in file order (overwrite
//     semantics of mask_target_layer.py:26-29); pass NULL to skip.
//     Returns -8 when a mask's dims differ from its box's floor/ceil extent.
// encode_mode: 0 = abs(clip(tsdf)), 1 = FLIP (trunc - abs), 2 = LOG.
int chunk_decode(const uint8_t* buf, uint64_t len, float truncation,
                 int encode_mode, float* data, float* boxes, uint32_t* labels,
                 float* fractions, float* world2chunk, uint32_t* frame_ids,
                 float* mask_canvas) {
  ChunkHeader h;
  int rc = chunk_peek(buf, len, &h);
  if (rc != 0) return rc;

  uint64_t off = 24;
  const uint64_t dx = h.dim_x, dy = h.dim_y, dz = h.dim_z;
  const float* sdf = reinterpret_cast<const float*>(buf + off);
  off += dx * dy * dz * 4;

  // Fortran (x fastest) -> C-order channels-last, fused encode.
  for (uint64_t z = 0; z < dz; z++) {
    for (uint64_t y = 0; y < dy; y++) {
      const float* src = sdf + (z * dy + y) * dx;
      for (uint64_t x = 0; x < dx; x++) {
        float v = src[x];
        float c = v;
        if (c > truncation) c = truncation;
        if (c < -truncation) c = -truncation;
        float a = std::fabs(c);
        float enc;
        switch (encode_mode) {
          case 1: enc = truncation - a; break;
          case 2: enc = std::log(a); break;
          default: enc = a; break;
        }
        float occ = (v > -1.0f) ? 1.0f : 0.0f;
        float* dst = data + ((x * dy + y) * dz + z) * 2;
        dst[0] = enc;
        dst[1] = occ;
      }
    }
  }

  off += 4;  // num_boxes
  for (uint32_t i = 0; i < h.num_boxes; i++) {
    std::memcpy(boxes + i * 6, buf + off, 24); off += 24;
    std::memcpy(labels + i, buf + off, 4); off += 4;
  }

  if (mask_canvas) {
    std::memset(mask_canvas, 0, dx * dy * dz * sizeof(float));
  }
  off += 4;  // num_masks
  for (uint32_t i = 0; i < h.num_masks; i++) {
    off += 4;  // label (redundant)
    uint64_t mx, my, mz;
    std::memcpy(&mx, buf + off, 8); off += 8;
    std::memcpy(&my, buf + off, 8); off += 8;
    std::memcpy(&mz, buf + off, 8); off += 8;
    const uint16_t* m = reinterpret_cast<const uint16_t*>(buf + off);
    off += mx * my * mz * 2;
    if (!mask_canvas || i >= h.num_boxes) continue;
    // paint at floor/ceil of the raw box (dataset floor/ceil rounding)
    const float* b = boxes + i * 6;
    int64_t x0 = (int64_t)std::floor(b[0]), y0 = (int64_t)std::floor(b[1]),
            z0 = (int64_t)std::floor(b[2]);
    int64_t x1 = (int64_t)std::ceil(b[3]), y1 = (int64_t)std::ceil(b[4]),
            z1 = (int64_t)std::ceil(b[5]);
    // the paint indexes the mask by the box's extent: a mask of other dims
    // would be read out of its bounds (the caller takes the numpy path)
    if ((int64_t)mx != x1 - x0 || (int64_t)my != y1 - y0 ||
        (int64_t)mz != z1 - z0) {
      return -8;
    }
    for (int64_t x = x0 < 0 ? 0 : x0; x < x1 && x < (int64_t)dx; x++) {
      for (int64_t y = y0 < 0 ? 0 : y0; y < y1 && y < (int64_t)dy; y++) {
        for (int64_t z = z0 < 0 ? 0 : z0; z < z1 && z < (int64_t)dz; z++) {
          // mask is F-order over its own (x1-x0, y1-y0, z1-z0) dims
          uint64_t mi = (uint64_t)((z - z0) * (y1 - y0) + (y - y0)) *
                            (uint64_t)(x1 - x0) + (uint64_t)(x - x0);
          uint16_t mv = m[mi];
          // values > 1 are cleared (dataset.py:100)
          mask_canvas[(x * dy + y) * dz + z] = (mv == 1) ? 1.0f : 0.0f;
        }
      }
    }
  }

  uint32_t nb2;
  std::memcpy(&nb2, buf + off, 4); off += 4;
  std::memcpy(fractions, buf + off, (uint64_t)nb2 * 4); off += (uint64_t)nb2 * 4;
  std::memcpy(world2chunk, buf + off, 64); off += 64;
  off += 4;  // num_images
  std::memcpy(frame_ids, buf + off, (uint64_t)h.num_images * 4);
  return 0;
}

}  // extern "C"
