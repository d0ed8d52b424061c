// Fused full-mesh linear blend skinning for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel empose_tpu/ops/skinning.py::lbs_apply_pallas
// (body _lbs_kernel).  Per frame n and vertex v:
//   T = A[n] (12 x J) . W^T[:, v]        A[n]'s column j is joint j's
//                                         [R_glob (row-major 3x3) | t_skin],
//                                         blended by the vertex's LBS weights;
//   out[n, v] = T[0:9] as 3x3 . v_posed[n, v] + T[9:12].
// The blended (N, V, 12) transforms stay in registers and never reach device
// memory.  R_glob (N, J, 3, 3) and t_skin (N, J, 3) are read in place: the
// kernel gathers them into its own joint-major layout, so the caller packs
// nothing.
//
// What bounds it on this card.  2 * 12 * J + 18 fp32 operations per (frame,
// vertex) against 24 bytes of v_posed in and out (W^T, 4 * J * V bytes, and
// the transforms are read once for all vertices): at J = 52 about 50
// operations per byte, above the fp32 line of 67 TFLOP/s over 3.35 TB/s (20
// per byte).  So from a few tens of frames on the bound is the fp32 FMA rate
// on the CUDA cores; with one frame the call is latency: one pass over W^T.
// At N = 512 the v_posed traffic alone (85 MB) is a third of the FMA time, so
// loads have to run beside the FMAs.
//
// Design:
//   * the work is (vertex tile, chunk of kChunk = 8 frames) units; the launch
//     plan (ops/skinning.py::lbs_launch_plan) takes tiles of 128 vertices, or
//     of 32 where few frames leave fewer units than SMs, and as many blocks as
//     the SMs hold at once; each block takes an even share of the units, so
//     no partial second wave trails the first;
//   * a block walks its units as segments of consecutive chunks of one tile:
//     it copies the segment's (J, kTileV) slice of W^T into shared memory
//     once, then the chunks, with a cp.async ring: while a chunk's FMAs run,
//     the next chunk's R_glob/t_skin rows (16-byte copies of the rows as they
//     lie in memory) and its v_posed slab are in flight; between chunks the
//     block gathers the landed rows into the joint-major [frame][joint][12]
//     layout that the FMA loop reads;
//   * thread (frame pair p, vertex quad q) holds a 2 x 12 x 4 register tile:
//     per joint one float4 of W and six float4 of A (broadcast: the threads
//     of a warp share their frames at kTileV = 128) feed 96 FMAs, and the
//     next joint's operands are loaded while those FMAs run; a chunk of one
//     or two frames at kTileV = 32 (N = 1) splits the joints over the four
//     thread rows instead and adds their tiles in row order;
//   * fp32 FMAs on the CUDA cores in a fixed joint order, no tensor cores
//     (TF32 would cost ~1e-3 at coordinates of a metre);
//   * the apply runs in registers and writes the port's (N, V, 3) layout; the
//     vertex tail (6890 = 53 * 128 + 106) and the frame tail are masked;
//   * no per-call host work beyond the launch: lbs_prepare sets the kernels'
//     shared-memory attributes once per device, and lbs_forward only
//     launches, so a call can be captured in a CUDA graph.

#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 8;           // frames per pipeline stage
constexpr int kPairs = kChunk / 2;  // frame pairs per chunk (one per thread row)
constexpr int kJointUnroll = 2;

// Error code beside cudaError_t values (which are >= 0).
constexpr int kErrBadShape = -4;

template <int kTileV>
struct Geometry {
  static constexpr int kQuads = kTileV / 4;            // vertex quads of a tile
  static constexpr int kThreads = kQuads * kPairs;     // one per (frame pair, quad)
  static constexpr int kStageV = kChunk * kTileV * 3;  // floats of a v_posed stage
};

template <int kBytes>
__device__ __forceinline__ void cp_async(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (kBytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d), "l"(src), "n"(kBytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
// Floats of one frame of the joint-major transforms: J joints x 12, plus 4
// so that the frames of one warp (kTileV = 32: four frame pairs per warp)
// fall in other banks.
__host__ __device__ constexpr int a_stride(int J) { return 12 * J + 4; }

template <int kTileV>
__host__ __device__ constexpr size_t smem_floats(int J) {
  return (size_t)J * kTileV + (size_t)kChunk * a_stride(J) + (size_t)kChunk * J * 12 +
         2 * (size_t)Geometry<kTileV>::kStageV;
}

// Thread `lane` of `lanes` starts its share of the copies of `count`
// floats, 16 bytes at a time when both ends allow it.
__device__ __forceinline__ void copy_floats(float* dst, const float* src, int count, bool vec16,
                                            int lane, int lanes) {
  if (vec16) {
    for (int i = 4 * lane; i < count; i += 4 * lanes) cp_async<16>(dst + i, src + i);
  } else {
    for (int i = lane; i < count; i += lanes) cp_async<4>(dst + i, src + i);
  }
}

// The v_posed rows of frames [c0, c0 + fc), vertices [v0, v0 + nv), into a
// stage of kChunk rows of kTileV * 3 floats; 8 bytes at a time when V is
// even (then every row and nv are even).
template <int kTileV>
__device__ __forceinline__ void copy_v(float* v_st, const float* __restrict__ v_posed, int c0,
                                       int fc, int V, int v0, int nv, bool vec8, int lane,
                                       int lanes) {
  constexpr int kRow = kTileV * 3;
  const int step = vec8 ? 2 : 1;
  for (int e = step * lane; e < fc * kRow; e += step * lanes) {
    const int f = e / kRow;
    const int i = e - f * kRow;
    if (i >= nv * 3) continue;
    const float* src = v_posed + ((size_t)(c0 + f) * V + v0) * 3 + i;
    if (vec8)
      cp_async<8>(v_st + e, src);
    else
      cp_async<4>(v_st + e, src);
  }
}

// Gather the landed R_glob/t_skin rows of fc frames into the joint-major
// [f][j][12] layout that the FMA loop reads as three float4 broadcasts per
// joint.
__device__ __forceinline__ void repack(float* a_st, const float* r_raw, const float* t_raw, int fc,
                                       int J, int lane, int lanes) {
  const int as = a_stride(J);
  for (int e = lane; e < fc * J; e += lanes) {
    const int f = e / J;
    const int j = e - f * J;
    const float* r = r_raw + (size_t)e * 9;
    const float* tt = t_raw + (size_t)e * 3;
    float4* dst = reinterpret_cast<float4*>(a_st + f * as + j * 12);
    dst[0] = make_float4(r[0], r[1], r[2], r[3]);
    dst[1] = make_float4(r[4], r[5], r[6], r[7]);
    dst[2] = make_float4(r[8], tt[0], tt[1], tt[2]);
  }
}

// One thread's register tile: kF frames (n, n + 1) x vertices [v0 + vl0,
// v0 + vl0 + 4) x 12 sums over the joints in order, each joint's operands
// loaded while the previous joint's FMAs run; then the apply to v_posed and
// the store of the frames before n_end.
template <int kTileV, int kF>
__device__ __forceinline__ void skin_tile(const float* a_f, const float* w_q, const float* v_f,
                                          float* __restrict__ out, int as, int J, int V, int n,
                                          int v0, int vl0, int nv, int n_end) {
  float acc[kF][12][4];
#pragma unroll
  for (int f = 0; f < kF; ++f)
#pragma unroll
    for (int r = 0; r < 12; ++r)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[f][r][k] = 0.0f;

  float4 w = *reinterpret_cast<const float4*>(w_q);
  float4 a[kF][3];
#pragma unroll
  for (int f = 0; f < kF; ++f)
#pragma unroll
    for (int i = 0; i < 3; ++i) a[f][i] = *reinterpret_cast<const float4*>(a_f + f * as + 4 * i);
#pragma unroll kJointUnroll
  for (int j = 0; j < J; ++j) {
    const int jn = j + 1 < J ? j + 1 : j;
    const float4 w_next = *reinterpret_cast<const float4*>(w_q + (size_t)jn * kTileV);
    float4 a_next[kF][3];
#pragma unroll
    for (int f = 0; f < kF; ++f)
#pragma unroll
      for (int i = 0; i < 3; ++i)
        a_next[f][i] = *reinterpret_cast<const float4*>(a_f + f * as + jn * 12 + 4 * i);
#pragma unroll
    for (int f = 0; f < kF; ++f) {
      const float av[12] = {a[f][0].x, a[f][0].y, a[f][0].z, a[f][0].w, a[f][1].x, a[f][1].y,
                            a[f][1].z, a[f][1].w, a[f][2].x, a[f][2].y, a[f][2].z, a[f][2].w};
#pragma unroll
      for (int r = 0; r < 12; ++r) {
        acc[f][r][0] = fmaf(av[r], w.x, acc[f][r][0]);
        acc[f][r][1] = fmaf(av[r], w.y, acc[f][r][1]);
        acc[f][r][2] = fmaf(av[r], w.z, acc[f][r][2]);
        acc[f][r][3] = fmaf(av[r], w.w, acc[f][r][3]);
      }
    }
    w = w_next;
#pragma unroll
    for (int f = 0; f < kF; ++f)
#pragma unroll
      for (int i = 0; i < 3; ++i) a[f][i] = a_next[f][i];
  }

#pragma unroll
  for (int f = 0; f < kF; ++f) {
    if (n + f < n_end) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int vl = vl0 + k;
        if (vl < nv) {
          const float* vp = v_f + f * kTileV * 3 + vl * 3;
          const float x = vp[0], y = vp[1], z = vp[2];
          float* o = out + ((size_t)(n + f) * V + v0 + vl) * 3;
#pragma unroll
          for (int d = 0; d < 3; ++d)
            o[d] = fmaf(acc[f][3 * d][k], x,
                        fmaf(acc[f][3 * d + 1][k], y,
                             fmaf(acc[f][3 * d + 2][k], z, acc[f][9 + d][k])));
        }
      }
    }
  }
}

// A chunk of kF <= 2 frames at kTileV = 32 (few frames: N = 1, 2, the tail
// of N = 9, 10): the four thread rows split the joints into four runs, and
// row 0 adds the other rows' partial tiles, passed through `part` (kPairs - 1
// partial tiles per quad), in row order before the apply.  Its joint loop is
// kept apart from skin_tile's: one shared loop function changed how ptxas
// allocated the 128-vertex kernel's registers and slowed it on the H100.
template <int kTileV, int kF>
__device__ __forceinline__ void skin_split(const float* a_s, const float* w_q, const float* v_f,
                                           float* part, float* __restrict__ out, int as, int J,
                                           int V, int c0, int n_end, int v0, int q, int p,
                                           int nv) {
  float acc[kF][12][4];
#pragma unroll
  for (int f = 0; f < kF; ++f)
#pragma unroll
    for (int r = 0; r < 12; ++r)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[f][r][k] = 0.0f;
  const int j1 = (p + 1) * J / kPairs;
  for (int j = p * J / kPairs; j < j1; ++j) {
    const float4 w = *reinterpret_cast<const float4*>(w_q + (size_t)j * kTileV);
#pragma unroll
    for (int f = 0; f < kF; ++f) {
      const float* a_j = a_s + f * as + j * 12;
      const float4 a0 = *reinterpret_cast<const float4*>(a_j);
      const float4 a1 = *reinterpret_cast<const float4*>(a_j + 4);
      const float4 a2 = *reinterpret_cast<const float4*>(a_j + 8);
      const float av[12] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y,
                            a1.z, a1.w, a2.x, a2.y, a2.z, a2.w};
#pragma unroll
      for (int r = 0; r < 12; ++r) {
        acc[f][r][0] = fmaf(av[r], w.x, acc[f][r][0]);
        acc[f][r][1] = fmaf(av[r], w.y, acc[f][r][1]);
        acc[f][r][2] = fmaf(av[r], w.z, acc[f][r][2]);
        acc[f][r][3] = fmaf(av[r], w.w, acc[f][r][3]);
      }
    }
  }
  constexpr int kTile = kF * 12 * 4;
  if (p > 0) {
    float* mine = part + (size_t)((p - 1) * Geometry<kTileV>::kQuads + q) * kTile;
#pragma unroll
    for (int i = 0; i < kTile; ++i) mine[i] = (&acc[0][0][0])[i];
  }
  __syncthreads();
  if (p != 0) return;
  for (int o = 1; o < kPairs; ++o) {
    const float* other = part + (size_t)((o - 1) * Geometry<kTileV>::kQuads + q) * kTile;
#pragma unroll
    for (int i = 0; i < kTile; ++i) (&acc[0][0][0])[i] += other[i];
  }
#pragma unroll
  for (int f = 0; f < kF; ++f) {
    if (c0 + f < n_end) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int vl = 4 * q + k;
        if (vl < nv) {
          const float* vp = v_f + f * kTileV * 3 + vl * 3;
          const float x = vp[0], y = vp[1], z = vp[2];
          float* o = out + ((size_t)(c0 + f) * V + v0 + vl) * 3;
#pragma unroll
          for (int d = 0; d < 3; ++d)
            o[d] = fmaf(acc[f][3 * d][k], x,
                        fmaf(acc[f][3 * d + 1][k], y,
                             fmaf(acc[f][3 * d + 2][k], z, acc[f][9 + d][k])));
        }
      }
    }
  }
}

// Shared-memory layout (floats):
//   w_s   [J][kTileV]              the segment's columns of W^T, 0 past the last vertex
//   a_s   [kChunk][12 J + 4]       the current chunk's transforms, joint-major
//   r_raw [kChunk][J][9], t_raw [kChunk][J][3]
//                                  the next chunk's R_glob and t_skin rows, in flight
//   v_s   [2][kChunk][kTileV * 3]  two stages of the chunks' v_posed rows
//
// Skins frames [n_begin, n_end) of vertices [v0, v0 + nv): loads the W^T
// tile and the first chunk, then walks over the chunks with the next one in
// flight.
template <int kTileV>
__device__ __forceinline__ void skin_segment(float* smem, const float* __restrict__ R,
                                             const float* __restrict__ t,
                                             const float* __restrict__ wt,
                                             const float* __restrict__ v_posed,
                                             float* __restrict__ out, int J, int V, int v0,
                                             int n_begin, int n_end, bool vec16, bool vec8) {
  using G = Geometry<kTileV>;
  constexpr int kT = G::kThreads;
  const int as = a_stride(J);
  float* w_s = smem;
  float* a_s = w_s + (size_t)J * kTileV;
  float* r_raw = a_s + kChunk * as;
  float* t_raw = r_raw + kChunk * J * 9;
  float* v_s = t_raw + kChunk * J * 3;
  const int tid = threadIdx.x;
  const int nv = min(kTileV, V - v0);
  const int n_chunks = (n_end - n_begin + kChunk - 1) / kChunk;
  const int step = vec8 ? 2 : 1;
  for (int idx = step * tid; idx < J * kTileV; idx += step * kT) {
    const int j = idx / kTileV;
    const int v = idx - j * kTileV;
    const float* src = wt + (size_t)j * V + v0 + v;
    if (v >= nv) {
      w_s[idx] = 0.0f;
      if (vec8) w_s[idx + 1] = 0.0f;
    } else if (vec8) {
      cp_async<8>(w_s + idx, src);
    } else {
      cp_async<4>(w_s + idx, src);
    }
  }
  const int fc0 = min(kChunk, n_end - n_begin);
  copy_floats(r_raw, R + (size_t)n_begin * J * 9, fc0 * J * 9, vec16, tid, kT);
  copy_floats(t_raw, t + (size_t)n_begin * J * 3, fc0 * J * 3, vec16, tid, kT);
  copy_v<kTileV>(v_s, v_posed, n_begin, fc0, V, v0, nv, vec8, tid, kT);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  repack(a_s, r_raw, t_raw, fc0, J, tid, kT);
  __syncthreads();
  if (n_chunks > 1) {
    const int c1 = n_begin + kChunk, fc1 = min(kChunk, n_end - c1);
    copy_floats(r_raw, R + (size_t)c1 * J * 9, fc1 * J * 9, vec16, tid, kT);
    copy_floats(t_raw, t + (size_t)c1 * J * 3, fc1 * J * 3, vec16, tid, kT);
    copy_v<kTileV>(v_s + G::kStageV, v_posed, c1, fc1, V, v0, nv, vec8, tid, kT);
    cp_async_commit();
  }
  const int q = tid % G::kQuads;
  const int p = tid / G::kQuads;
  const float* w_q = w_s + 4 * q;
  for (int c = 0; c < n_chunks; ++c) {
    const int c0 = n_begin + c * kChunk;
    const int n = c0 + 2 * p;  // this thread's frames n, n + 1
    const float* a_f = a_s + 2 * p * as;
    const float* v_f = v_s + (c & 1) * G::kStageV + 2 * p * kTileV * 3;
    bool split = false;
    if constexpr (kTileV == 32) {
      split = n_end - c0 <= 2;  // the segment's last chunk: r_raw is free
      const float* v_c = v_s + (c & 1) * G::kStageV;
      if (n_end - c0 == 1)
        skin_split<kTileV, 1>(a_s, w_q, v_c, r_raw, out, as, J, V, c0, n_end, v0, q, p, nv);
      else if (split)
        skin_split<kTileV, 2>(a_s, w_q, v_c, r_raw, out, as, J, V, c0, n_end, v0, q, p, nv);
    }
    if (!split && n + 1 < n_end)
      skin_tile<kTileV, 2>(a_f, w_q, v_f, out, as, J, V, n, v0, 4 * q, nv, n_end);
    else if (!split && n < n_end)
      skin_tile<kTileV, 1>(a_f, w_q, v_f, out, as, J, V, n, v0, 4 * q, nv, n_end);
    if (c + 1 < n_chunks) {
      // Chunk c + 1 has landed while chunk c's FMAs ran; every thread is
      // done with a_s and with chunk c's v_posed stage.
      cp_async_wait_all();
      __syncthreads();
      repack(a_s, r_raw, t_raw, min(kChunk, n_end - c0 - kChunk), J, tid, kT);
      __syncthreads();
      if (c + 2 < n_chunks) {
        const int c2 = c0 + 2 * kChunk, fc2 = min(kChunk, n_end - c2);
        copy_floats(r_raw, R + (size_t)c2 * J * 9, fc2 * J * 9, vec16, tid, kT);
        copy_floats(t_raw, t + (size_t)c2 * J * 3, fc2 * J * 3, vec16, tid, kT);
        copy_v<kTileV>(v_s + (c & 1) * G::kStageV, v_posed, c2, fc2, V, v0, nv, vec8, tid, kT);
        cp_async_commit();
      }
    }
  }
}

// The work is (vertex tile, chunk) units, tile-major: unit u skins chunk
// u % chunks of tile u / chunks.  Block b takes units [b U / B, (b + 1) U /
// B) of U = tiles * chunks over B = gridDim.x blocks, as segments of
// consecutive chunks of one tile each: its W^T tile is loaded once per
// segment.
template <int kTileV>
__global__ void __launch_bounds__(Geometry<kTileV>::kThreads)
lbs_kernel(const float* __restrict__ R,        // (N, J, 3, 3)
           const float* __restrict__ t,        // (N, J, 3)
           const float* __restrict__ wt,       // (J, V)
           const float* __restrict__ v_posed,  // (N, V, 3)
           float* __restrict__ out,            // (N, V, 3)
           int N, int J, int V) {
  extern __shared__ __align__(16) float smem[];
  const int chunks = (N + kChunk - 1) / kChunk;
  const long long units = (long long)chunks * ((V + kTileV - 1) / kTileV);
  const long long u_end = (blockIdx.x + 1) * units / gridDim.x;
  const bool vec16 = J % 4 == 0 && (reinterpret_cast<size_t>(R) & 15) == 0 &&
                     (reinterpret_cast<size_t>(t) & 15) == 0;
  const bool vec8 = V % 2 == 0 && (reinterpret_cast<size_t>(v_posed) & 7) == 0 &&
                    (reinterpret_cast<size_t>(wt) & 7) == 0;
  for (long long u = blockIdx.x * units / gridDim.x; u < u_end;) {
    const int tile = (int)(u / chunks);
    const int c_first = (int)(u - (long long)tile * chunks);
    const int c_last = (int)min((long long)chunks, c_first + (u_end - u));
    skin_segment<kTileV>(smem, R, t, wt, v_posed, out, J, V, tile * kTileV, c_first * kChunk,
                         min(N, c_last * kChunk), vec16, vec8);
    u += c_last - c_first;
    __syncthreads();  // the next segment refills every buffer
  }
}

template <int kTileV>
cudaError_t set_attributes(int max_smem) {
  const cudaError_t err = cudaFuncSetAttribute(lbs_kernel<kTileV>,
                                               cudaFuncAttributePreferredSharedMemoryCarveout,
                                               (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(lbs_kernel<kTileV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              max_smem);
}

template <int kTileV>
int launch(const float* R, const float* t, const float* wt, const float* v_posed, float* out,
           int N, int J, int V, int blocks, cudaStream_t stream) {
  lbs_kernel<kTileV><<<blocks, Geometry<kTileV>::kThreads, sizeof(float) * smem_floats<kTileV>(J),
                       stream>>>(
      R, t, wt, v_posed, out, N, J, V);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Once per device, before the first launch there (and outside any CUDA graph
// capture): lets both kernels use the card's opt-in shared memory per block
// and prefer shared memory over L1.  Writes that opt-in limit in bytes to
// *max_smem.  Returns 0 or a cudaError_t value.
int lbs_prepare(int device, int* max_smem) {
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return (int)err;
  err = cudaSetDevice(device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err == cudaSuccess) err = set_attributes<128>(*max_smem);
  if (err == cudaSuccess) err = set_attributes<32>(*max_smem);
  cudaSetDevice(prev);
  return (int)err;
}

// Skins N frames of a V-vertex mesh with J joints on `stream`: R (N, J, 3, 3)
// and t (N, J, 3) the joints' global rotations and skinning translations, wt
// (J, V) the transposed LBS weights, v_posed (N, V, 3) -> out (N, V, 3), all
// contiguous fp32.  tile_v (128 or 32) and blocks come from the launch plan.
// Launches only: lbs_prepare must have run on the current device.  Returns 0,
// a cudaError_t value, or a negative code above.
int lbs_forward(const float* R, const float* t, const float* wt, const float* v_posed, float* out,
                int N, int J, int V, int tile_v, int blocks, void* stream) {
  if (N <= 0 || J <= 0 || V <= 0 || blocks <= 0) return kErrBadShape;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tile_v == 128) return launch<128>(R, t, wt, v_posed, out, N, J, V, blocks, s);
  if (tile_v == 32) return launch<32>(R, t, wt, v_posed, out, N, J, V, blocks, s);
  return kErrBadShape;
}

}  // extern "C"
