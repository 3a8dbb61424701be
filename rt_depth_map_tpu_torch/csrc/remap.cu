// Fixed-point bilinear remap of a uint8 image through quantized map tables.
//
// Replaces rt_depth_map_tpu/ops/pallas/remap_plan.py remap_bilinear_planned
// (and the gather of ops/remap.py remap_bilinear, uint8 path). On the TPU the
// gather was slow, so the JAX package planned a static select network per
// map. Hopper gathers well, so this is the plain gather: one thread per
// output pixel, all channels.
//
// What bounds it on the H100: device memory bytes. Per output pixel it reads
// the tables (ix, iy int32; fx, fy, valid uint8: 11 bytes) and four source
// taps per channel, most of them from L1/L2 because neighbouring output
// pixels sample neighbouring source pixels; it writes C bytes. At 1280x720
// that is ~10 MB of tables, a few microseconds at HBM rate. The design does
// nothing more about it: the quantization was moved to the host, so the
// kernel reads integers only and no float rounding can differ from the
// reference.
//
// Semantics (bit-exact with the JAX uint8 path): 1/32-px fractions fx, fy,
// weights (32-fx)(32-fy), fx(32-fy), (32-fx)fy, fx*fy summing to 1024,
// rounded by (acc + 512) >> 10; taps outside the image read 0; pixels whose
// window lies fully outside the image (valid == 0) write 0.

#include <cuda_runtime.h>
#include <stdint.h>

__global__ void remap_u8_kernel(const uint8_t* __restrict__ img, int H, int W,
                                int C, const int32_t* __restrict__ ix,
                                const int32_t* __restrict__ iy,
                                const uint8_t* __restrict__ fx,
                                const uint8_t* __restrict__ fy,
                                const uint8_t* __restrict__ valid,
                                uint8_t* __restrict__ out, int n) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  uint8_t* o = out + (size_t)p * C;
  if (!valid[p]) {
    for (int c = 0; c < C; ++c) o[c] = 0;
    return;
  }
  // valid implies x0 in [-1, W-1] and y0 in [-1, H-1]
  const int x0 = ix[p], y0 = iy[p];
  const int ax = fx[p], ay = fy[p];
  const int w00 = (32 - ax) * (32 - ay), w01 = ax * (32 - ay);
  const int w10 = (32 - ax) * ay, w11 = ax * ay;
  const bool left = x0 >= 0, right = x0 + 1 < W;
  const bool top = y0 >= 0, bottom = y0 + 1 < H;
  const size_t i00 = ((size_t)(y0 + 1) * W + (x0 + 1)) * C;  // (y0+1, x0+1) is in range
  const size_t row = (size_t)W * C;
  for (int c = 0; c < C; ++c) {
    const size_t i11 = i00 + c;  // index of tap (y0+1, x0+1)
    const int p00 = (top && left) ? img[i11 - row - C] : 0;
    const int p01 = (top && right) ? img[i11 - row] : 0;
    const int p10 = (bottom && left) ? img[i11 - C] : 0;
    const int p11 = (bottom && right) ? img[i11] : 0;
    o[c] = (uint8_t)((p00 * w00 + p01 * w01 + p10 * w10 + p11 * w11 + 512) >> 10);
  }
}

extern "C" int rtdm_remap_u8(const void* img, int H, int W, int C,
                             const void* ix, const void* iy, const void* fx,
                             const void* fy, const void* valid, void* out,
                             int n, void* stream) {
  if (n > 0) {
    const int threads = 256;
    remap_u8_kernel<<<(n + threads - 1) / threads, threads, 0,
                      (cudaStream_t)stream>>>(
        (const uint8_t*)img, H, W, C, (const int32_t*)ix, (const int32_t*)iy,
        (const uint8_t*)fx, (const uint8_t*)fy, (const uint8_t*)valid,
        (uint8_t*)out, n);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* rtdm_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
