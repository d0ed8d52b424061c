// Fused full-mesh linear blend skinning for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel empose_tpu/ops/skinning.py::lbs_apply_pallas
// (body _lbs_kernel).  Per frame n and vertex v:
//   T = A[n] (12 x J) . W^T[:, v]        the joints' [R | t_skin] blended by
//                                         the vertex's LBS weights;
//   out[n, v] = T[0:9] as 3x3 . v_posed[n, v] + T[9:12].
// The blended (N, V, 12) transforms stay in registers and never reach device
// memory.
//
// What bounds it on this card.  2 * 12 * J + 18 operations per (frame,
// vertex) against 24 bytes of v_posed in and out (W^T, 4 * J * V bytes, is
// read once for all frames): at J = 52 about 50 operations per byte, above
// the fp32 line of 67 TFLOP/s over 3.35 TB/s (20 per byte).  So with many
// frames the bound is the fp32 FMA rate; with one frame it is reading W^T.
// Design:
//   * a block owns a tile of kTileV = 128 vertices and kFrames = 8 frames:
//     the (J, 128) tile of W^T is read once, as coalesced rows, and serves
//     the 8 frames; their A, transposed to joint-major [f][j][12], sit beside
//     it in shared memory (J * 896 B: 46.6 KB at J = 52);
//   * thread (frame f, vertex quad q) accumulates the 12 x 4 register tile
//     T[:, 4q..4q+3] of frame f over the joints in a fixed order: per joint
//     one float4 of W and three float4 of A (a broadcast: the 32 threads of a
//     warp share the frame) feed 48 FMAs;
//   * the apply runs in registers and writes the port's (N, V, 3) layout
//     directly, so the TPU kernel's two transposes and its padding of V to a
//     multiple of 512 go away; the ragged last vertex tile (6890 = 53 * 128
//     + 106) and frame tile are masked;
//   * fp32 FMAs on the CUDA cores, no tensor cores (TF32 would cost ~1e-3 at
//     coordinates of a metre).

#include <cuda_runtime.h>

namespace {

constexpr int kTileV = 128;               // vertices per block
constexpr int kQuads = kTileV / 4;        // threads per frame (one vertex quad each)
constexpr int kFrames = 8;                // frames per block
constexpr int kThreads = kQuads * kFrames;

// Error codes beside cudaError_t values (which are >= 0).
constexpr int kErrSharedTooLarge = -2;
constexpr int kErrBadShape = -4;

// Shared-memory layout (floats):
//   w_s [J][kTileV]      this block's columns of W^T, 0 past the last vertex
//   a_s [kFrames][J][12] the block's frames' A, joint-major, 0 past the last frame
__global__ void __launch_bounds__(kThreads)
lbs_kernel(const float* __restrict__ a,        // (N, 12, J)
           const float* __restrict__ wt,       // (J, V)
           const float* __restrict__ v_posed,  // (N, V, 3)
           float* __restrict__ out,            // (N, V, 3)
           int N, int J, int V) {
  extern __shared__ __align__(16) float smem[];
  float* w_s = smem;
  float* a_s = w_s + (size_t)J * kTileV;

  const int tid = threadIdx.x;
  const int q = tid % kQuads;
  const int f = tid / kQuads;
  const int n0 = blockIdx.x * kFrames;
  const int v0 = blockIdx.y * kTileV;

  for (int idx = tid; idx < J * kTileV; idx += kThreads) {
    const int j = idx / kTileV;
    const int v = v0 + idx % kTileV;
    w_s[idx] = v < V ? wt[(size_t)j * V + v] : 0.0f;
  }
  // One (frame, joint) row of A per thread and pass: 12 reads, each
  // coalesced over the joints, and three float4 stores.
  for (int e = tid; e < kFrames * J; e += kThreads) {
    const int fl = e / J;
    const int j = e - fl * J;
    const int n = n0 + fl;
    float row[12];
#pragma unroll
    for (int r = 0; r < 12; ++r) row[r] = n < N ? a[((size_t)n * 12 + r) * J + j] : 0.0f;
    float4* dst = reinterpret_cast<float4*>(a_s + (size_t)e * 12);
    dst[0] = make_float4(row[0], row[1], row[2], row[3]);
    dst[1] = make_float4(row[4], row[5], row[6], row[7]);
    dst[2] = make_float4(row[8], row[9], row[10], row[11]);
  }
  __syncthreads();

  const int n = n0 + f;
  if (n >= N) return;

  float acc[12][4];
#pragma unroll
  for (int r = 0; r < 12; ++r)
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[r][k] = 0.0f;

  const float* a_f = a_s + (size_t)f * J * 12;
  const float* w_q = w_s + 4 * q;
#pragma unroll 4
  for (int j = 0; j < J; ++j) {
    const float4 w = *reinterpret_cast<const float4*>(w_q + (size_t)j * kTileV);
    const float4 a0 = *reinterpret_cast<const float4*>(a_f + j * 12);
    const float4 a1 = *reinterpret_cast<const float4*>(a_f + j * 12 + 4);
    const float4 a2 = *reinterpret_cast<const float4*>(a_f + j * 12 + 8);
    const float av[12] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w, a2.x, a2.y, a2.z, a2.w};
#pragma unroll
    for (int r = 0; r < 12; ++r) {
      acc[r][0] = fmaf(av[r], w.x, acc[r][0]);
      acc[r][1] = fmaf(av[r], w.y, acc[r][1]);
      acc[r][2] = fmaf(av[r], w.z, acc[r][2]);
      acc[r][3] = fmaf(av[r], w.w, acc[r][3]);
    }
  }

#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int v = v0 + 4 * q + k;
    if (v < V) {
      const size_t off = ((size_t)n * V + v) * 3;
      const float x = v_posed[off], y = v_posed[off + 1], z = v_posed[off + 2];
#pragma unroll
      for (int d = 0; d < 3; ++d)
        out[off + d] = fmaf(acc[3 * d][k], x,
                            fmaf(acc[3 * d + 1][k], y, fmaf(acc[3 * d + 2][k], z, acc[9 + d][k])));
    }
  }
}

}  // namespace

extern "C" {

// Skins N frames of a V-vertex mesh with J joints on `stream`: a (N, 12, J)
// packed transforms, wt (J, V) transposed LBS weights, v_posed (N, V, 3) ->
// out (N, V, 3).  Returns 0, a cudaError_t value, or a negative code above.
int lbs_forward(const float* a, const float* wt, const float* v_posed, float* out, int N, int J,
                int V, void* stream) {
  if (N <= 0 || J <= 0 || V <= 0) return kErrBadShape;
  const size_t smem = sizeof(float) * (size_t)J * (kTileV + kFrames * 12);
  int dev = 0, max_smem = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (smem > (size_t)max_smem) return kErrSharedTooLarge;
  cudaError_t err =
      cudaFuncSetAttribute(lbs_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + kFrames - 1) / kFrames, (V + kTileV - 1) / kTileV);
  if (grid.y > 65535u) return kErrBadShape;
  lbs_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a, wt, v_posed, out, N, J,
                                                                         V);
  return (int)cudaGetLastError();
}

}  // extern "C"
