// Host side of the TMA loads of the wgmma kernels (flash_fwd.cu,
// flash_bwd.cu): the tensor map of a strided bf16 (B, rows, H, d) view, as
// the launch plans report its fields, and its encoding through the driver.
// A map has boxes of 64 head dims (128 bytes, the row of the 128-byte
// swizzle) by `box_rows` rows and zero-fills every element past the view's
// bounds.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ldm3d {

constexpr int TMA_BOX_DIMS = 64;  // head dims a box

// cuTensorMapEncodeTiled, a driver call, through the runtime's entry-point
// lookup (no link against libcuda).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// The fields of the tensor map of a (B, rows, H, d) bf16 view with element
// strides (sb, sn, sh) and unit stride on d: dims (d, rows, H, B), the byte
// strides of dims 1-3, boxes of 64 dims x box_rows rows. A dim of size one
// may have any stride; it is given a whole-16-byte one.
struct MapFields {
  cuuint64_t dims[4];
  cuuint64_t strides[3];
  cuuint32_t box[4];
};

inline MapFields bf16_map_fields(int B, int rows, int H, int d, int64_t sb, int64_t sn,
                                 int64_t sh, int box_rows) {
  const auto r16 = [](int64_t x) { return (x + 15) / 16 * 16; };
  int64_t bn = sn * 2, bhh = sh * 2, bb = sb * 2;
  if (rows == 1) bn = r16(d * 2);
  if (H == 1) bhh = r16(bn * rows);
  if (B == 1) bb = r16(bhh * H);
  return {{(cuuint64_t)d, (cuuint64_t)rows, (cuuint64_t)H, (cuuint64_t)B},
          {(cuuint64_t)bn, (cuuint64_t)bhh, (cuuint64_t)bb},
          {(cuuint32_t)TMA_BOX_DIMS, (cuuint32_t)box_rows, 1, 1}};
}

// The 11 numbers of a map as the plans report them: dims, byte strides, box.
inline int64_t* put_map_fields(int64_t* out, const MapFields& m) {
  for (int i = 0; i < 4; ++i) *out++ = (int64_t)m.dims[i];
  for (int i = 0; i < 3; ++i) *out++ = (int64_t)m.strides[i];
  for (int i = 0; i < 4; ++i) *out++ = (int64_t)m.box[i];
  return out;
}

// Encode `f` for the data at `ptr` in the 128-byte swizzle, zeros past every
// bound. Returns false if the driver refuses the map.
inline bool encode_bf16_map(CUtensorMap* map, const void* ptr, const MapFields& f) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), f.dims, f.strides,
            f.box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace ldm3d
