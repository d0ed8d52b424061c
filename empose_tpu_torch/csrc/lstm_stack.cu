// Weight-resident LSTM stack forward for Hopper (sm_90a), one cooperative launch.
//
// Replaces the Pallas TPU kernel empose_tpu/ops/lstm_kernel.py::_pallas_forward
// (body _make_kernel): the inference forward of a unidirectional L-layer LSTM
// stack over F steps, gates in torch order (i, f, g, o).  Layer 0's gate input
// is the hoisted projection x0_proj (both biases folded in, computed outside
// as one GEMM); deeper layers use prev_out @ W_ih + b.  Where mask == 0 the
// (h, c) state is frozen bit for bit and the step's output is h_new * mask.
//
// What bounds it on this card.  The recurrence is serial in time, and every
// step needs all (2L-1) weight matrices: 12.6 MB at L=2, H=512.  Re-reading
// them from device memory each step (what a loop of library GEMMs does) makes
// the stack weight-reload-bound; with the weights resident the least time is
// the fp32 FMA work, 2*F*N*H*4H*(2L-1) operations, which at N=64 is above the
// card's bytes line.  The TPU kernel kept all weights in one core's 16 MB
// VMEM.  One H100 SM has 227 KB of shared memory, so here the weights are
// spread over the SMs instead:
//   * each block owns U consecutive hidden units j and computes their four
//     gate columns {j, H+j, 2H+j, 3H+j} for every batch row, so the c/h
//     update of a unit never leaves its block;
//   * the block's columns of W_hh (every layer) and W_ih (layers >= 1) are
//     loaded into dynamic shared memory once and stay there for all F steps
//     (3 * 512 * 16 * 4 B = 96 KB at L=2, H=512, U=4);
//   * the h of every layer goes through a double-buffered global buffer that
//     stays in L2, and one grid-wide barrier separates dependent phases:
//     L barriers per time step;
//   * fp32 FMAs on the CUDA cores, no tensor cores (the fp32 parity mode).
//     Inside a block the loop is bound by shared-memory reads, not FMAs:
//     each thread multiplies 4 batch rows by its unit's 4 gate columns over
//     a quarter of every k-tile (8 float4 reads per 64 FMAs), and the four
//     partial sums meet in shared memory.
// The grid must be co-resident for the barrier, so the host side launches it
// with cudaLaunchCooperativeKernel and refuses a grid that does not fit.
//
// The same kernel runs the wavefront schedule (lstm_wavefront_forward), which
// replaces the Pallas TPU kernel empose_tpu/ops/lstm_kernel.py::
// _pallas_wavefront: in phase p every layer l with 0 <= p - l < F steps at
// its own time t = p - l, so the stack needs F + L - 1 grid barriers instead
// of F * L.  Each phase then does up to L gate products per block, one after
// the other; the weights, tiles and exchange buffer are the stack's.  Layer
// l >= 1's input is layer l-1's state at the same time t, written one phase
// earlier, times mask[t]: the output h_new * m of the TPU kernel's pipe.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;

// k-width of one staged activation tile, per units-per-block U: the widest
// that keeps weights + two tiles inside a block's 227 KB at L=2 (fewer
// tiles = fewer block barriers per phase).
__host__ __device__ constexpr int tile_k(int U) { return U == 1 ? 32 : U == 2 ? 64 : U == 4 ? 128 : 64; }

// Error codes beside cudaError_t values (which are >= 0).
constexpr int kErrGridTooLarge = -1;
constexpr int kErrSharedTooLarge = -2;
constexpr int kErrNoCooperative = -3;
constexpr int kErrBadShape = -4;

__device__ __forceinline__ float sigmoid_f(float x) { return 1.0f / (1.0f + expf(-x)); }

// Thread layout.  Thread t = ((ks * RGN) + rg) * U + u owns unit j0 + u,
// the R rows {rg, rg + RGN, ...} of each pass of RG = R * RGN rows, and the
// ks-th quarter of every staged k-tile: per 4 k it reads 4 weight float4
// (the unit's four gates) and R activation float4, and does 16 R FMAs.  The
// KSPLIT partial sums are then added through shared memory by thread
// (row = t / U, unit u), which owns that (row, unit)'s c/h update.
constexpr int kRows = 4;    // R: batch rows per thread
constexpr int kSplit = 4;   // KSPLIT: ways the k range of a tile is split

// Shared-memory layout (floats):
//   w_s   [(2L-1)][H][U][4]  matrix m < L is W_hh[m], m >= L is W_ih_up[m-L]
//   b_s   [(L-1)][U][4]
//   h_s   [RG][KT + 4]       staged tile of h_prev rows (padded: float4-aligned,
//                            consecutive rows on distinct banks)
//   x_s   [RG][KT + 4]       staged tile of the layer input (layers >= 1)
//   red   [KSPLIT][RG][U][4] partial gate sums; aliases h_s/x_s after a tile sweep
template <int U, bool kWave>
__global__ void __launch_bounds__(kThreads)
lstm_stack_kernel(const float* __restrict__ x0_proj,   // (F, N, 4H)
                  const float* __restrict__ mask,      // (F, N)
                  const float* __restrict__ w_hh,      // (L, H, 4H)
                  const float* __restrict__ w_ih_up,   // (L-1, H, 4H) or null
                  const float* __restrict__ b_up,      // (L-1, 4H) or null
                  float* __restrict__ outs,            // (F, N, H)
                  float* hbuf,                         // (2, L, N, H), [0] holds h0
                  float* c_state,                      // (L, N, H), holds c0, ends as cF
                  float* __restrict__ h_final,         // (L, N, H)
                  int F, int N, int H, int L) {
  constexpr int RG = kThreads / U;           // batch rows per pass
  constexpr int RGN = RG / kRows;            // row groups per pass
  constexpr int KT = tile_k(U);
  constexpr int KTS = KT / kSplit;           // k per split per tile
  constexpr int KS = KT + 4;                 // padded tile row stride
  constexpr int V4 = RG * KT / 4 / kThreads; // float4 per thread per tile
  static_assert(V4 * 4 * kThreads == RG * KT, "tile must split evenly over the threads");
  static_assert(kSplit * RGN * U == kThreads, "thread layout must cover the block");
  static_assert(KTS % 4 == 0, "a split must be whole float4");
  static_assert(kSplit * RG * U * 4 <= 2 * RG * KS, "partial sums must fit the tiles they alias");
  extern __shared__ __align__(16) float smem[];
  const int n_mats = 2 * L - 1;
  float* w_s = smem;
  float* b_s = w_s + (size_t)n_mats * H * U * 4;
  float* h_s = b_s + (size_t)(L - 1) * U * 4;
  float* x_s = h_s + RG * KS;
  float* red = h_s;

  const int tid = threadIdx.x;
  const int u = tid % U;
  const int rg = (tid / U) % RGN;
  const int ks = tid / (U * RGN);
  const int r = tid / U;  // epilogue row within the pass
  const int j0 = blockIdx.x * U;
  const int j = j0 + u;
  const int H4 = 4 * H;
  const size_t NH = (size_t)N * H;
  const int n_tiles = (H + KT - 1) / KT;
  cg::grid_group grid = cg::this_grid();

  // Resident weights: this block's 4*U gate columns of every matrix
  // (with U a multiple of 4, one float4 read covers 4 units of one gate).
  for (int m = 0; m < n_mats; ++m) {
    const float* src = m < L ? w_hh + (size_t)m * H * H4 : w_ih_up + (size_t)(m - L) * H * H4;
    float* dst = w_s + (size_t)m * H * U * 4;
    if constexpr (U % 4 == 0) {
      constexpr int Q = U / 4;
#pragma unroll 4
      for (int idx = tid; idx < H * 4 * Q; idx += kThreads) {
        const int k = idx / (4 * Q);
        const int g = (idx / Q) % 4;
        const int q = idx % Q;
        const float4 v = *reinterpret_cast<const float4*>(src + (size_t)k * H4 + g * H + j0 + 4 * q);
        float* d = dst + ((size_t)k * U + 4 * q) * 4 + g;
        d[0] = v.x; d[4] = v.y; d[8] = v.z; d[12] = v.w;
      }
    } else {
#pragma unroll 4
      for (int idx = tid; idx < H * U * 4; idx += kThreads) {
        const int k = idx / (U * 4);
        const int uu = (idx / 4) % U;
        const int g = idx % 4;
        dst[idx] = src[(size_t)k * H4 + g * H + j0 + uu];
      }
    }
  }
  for (int idx = tid; idx < (L - 1) * U * 4; idx += kThreads) {
    const int l = idx / (U * 4);
    const int uu = (idx / 4) % U;
    const int g = idx % 4;
    b_s[idx] = b_up[(size_t)l * H4 + g * H + j0 + uu];
  }
  __syncthreads();

  // Staging registers: the next tile is fetched from L2 while the current
  // one is multiplied (one tile in flight per thread).
  float4 h_reg[V4], x_reg[V4];
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);

  // Phases: the stack runs one (step, layer) per phase, F * L of them; the
  // wavefront runs layers l_first..l_last of phase p at times p - l.  Either
  // way layer l at time t reads its h from slot t & 1 and writes slot
  // (t & 1) ^ 1, and layer l-1's state at time t lies in slot (t & 1) ^ 1,
  // written one phase earlier; no slot is read and written in one phase.
  const int n_phases = kWave ? F + L - 1 : F * L;
  for (int p = 0; p < n_phases; ++p) {
    const int l_first = kWave ? max(0, p - F + 1) : p % L;
    const int l_last = kWave ? min(L - 1, p) : p % L;
    for (int l = l_first; l <= l_last; ++l) {
      const int t = kWave ? p - l : p / L;
      const int rd = t & 1;
      const int wr = rd ^ 1;
      const float* mask_t = mask + (size_t)t * N;
      const float* h_prev = hbuf + ((size_t)rd * L + l) * NH;
      float* h_next = hbuf + ((size_t)wr * L + l) * NH;
      // Layer l-1's state at time t; times the mask it is that layer's output.
      const float* x_in = l > 0 ? hbuf + ((size_t)wr * L + l - 1) * NH : nullptr;
      const float* w_rec = w_s + (size_t)l * H * U * 4 + u * 4;
      const float* w_inp = l > 0 ? w_s + (size_t)(L + l - 1) * H * U * 4 + u * 4 : nullptr;

      for (int n0 = 0; n0 < N; n0 += RG) {
        // __ldcg: these rows were written by other blocks before the last
        // grid barrier, so they are read from L2, never from a stale L1.
        auto fetch = [&](int k0) {
#pragma unroll
          for (int v = 0; v < V4; ++v) {
            const int e = (v * kThreads + tid) * 4;
            const int nn = n0 + e / KT;
            const int k = k0 + e % KT;
            const bool in = nn < N && k < H;
            const size_t off = (size_t)nn * H + k;
            h_reg[v] = in ? __ldcg(reinterpret_cast<const float4*>(h_prev + off)) : zero4;
            if (l > 0) {
              float4 xv = in ? __ldcg(reinterpret_cast<const float4*>(x_in + off)) : zero4;
              const float mv = in ? mask_t[nn] : 0.0f;
              xv.x *= mv; xv.y *= mv; xv.z *= mv; xv.w *= mv;
              x_reg[v] = xv;
            }
          }
        };

        float acc[kRows][4];
#pragma unroll
        for (int i = 0; i < kRows; ++i)
#pragma unroll
          for (int g = 0; g < 4; ++g) acc[i][g] = 0.0f;
        const bool active = n0 + rg < N;  // this thread has at least one real row

        // The epilogue's own reads are issued now so their latency hides
        // behind the tile sweep.
        const int n = n0 + r;
        const bool row_ok = n < N;
        const size_t off = (size_t)(row_ok ? n : 0) * H + j;
        float* c_ptr = c_state + (size_t)l * NH + off;
        float gate[4];
        float c_old = 0.0f, h_old = 0.0f, m = 0.0f;
        if (row_ok) {
          if (l == 0) {
            const float* xp = x0_proj + ((size_t)t * N + n) * H4 + j;
#pragma unroll
            for (int g = 0; g < 4; ++g) gate[g] = xp[g * H];
          } else {
#pragma unroll
            for (int g = 0; g < 4; ++g) gate[g] = b_s[((l - 1) * U + u) * 4 + g];
          }
          c_old = *c_ptr;
          h_old = __ldcg(h_prev + off);
          m = mask_t[n];
        }

        fetch(0);
        for (int tile = 0; tile < n_tiles; ++tile) {
          const int k0 = tile * KT;
          __syncthreads();  // the previous tile is consumed
#pragma unroll
          for (int v = 0; v < V4; ++v) {
            const int e = (v * kThreads + tid) * 4;
            *reinterpret_cast<float4*>(h_s + (e / KT) * KS + e % KT) = h_reg[v];
            if (l > 0) *reinterpret_cast<float4*>(x_s + (e / KT) * KS + e % KT) = x_reg[v];
          }
          __syncthreads();
          if (tile + 1 < n_tiles) fetch(k0 + KT);
          const int k_lo = ks * KTS;
          const int k_hi = active ? min(k_lo + KTS, H - k0) : k_lo;
          for (int kk = k_lo; kk < k_hi; kk += 4) {
            const float* wr_k = w_rec + (k0 + kk) * U * 4;
            float4 hv[kRows];
#pragma unroll
            for (int i = 0; i < kRows; ++i)
              hv[i] = *reinterpret_cast<const float4*>(h_s + (rg + i * RGN) * KS + kk);
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const float4 w = *reinterpret_cast<const float4*>(wr_k + q * U * 4);
#pragma unroll
              for (int i = 0; i < kRows; ++i) {
                const float a = q == 0 ? hv[i].x : q == 1 ? hv[i].y : q == 2 ? hv[i].z : hv[i].w;
                acc[i][0] = fmaf(a, w.x, acc[i][0]);
                acc[i][1] = fmaf(a, w.y, acc[i][1]);
                acc[i][2] = fmaf(a, w.z, acc[i][2]);
                acc[i][3] = fmaf(a, w.w, acc[i][3]);
              }
            }
            if (l > 0) {
              const float* wi_k = w_inp + (k0 + kk) * U * 4;
#pragma unroll
              for (int i = 0; i < kRows; ++i)
                hv[i] = *reinterpret_cast<const float4*>(x_s + (rg + i * RGN) * KS + kk);
#pragma unroll
              for (int q = 0; q < 4; ++q) {
                const float4 w = *reinterpret_cast<const float4*>(wi_k + q * U * 4);
#pragma unroll
                for (int i = 0; i < kRows; ++i) {
                  const float a = q == 0 ? hv[i].x : q == 1 ? hv[i].y : q == 2 ? hv[i].z : hv[i].w;
                  acc[i][0] = fmaf(a, w.x, acc[i][0]);
                  acc[i][1] = fmaf(a, w.y, acc[i][1]);
                  acc[i][2] = fmaf(a, w.z, acc[i][2]);
                  acc[i][3] = fmaf(a, w.w, acc[i][3]);
                }
              }
            }
          }
        }

        // Add the KSPLIT partial sums: red[ks][row][u][g].
        __syncthreads();  // the last tile is consumed; red aliases it
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          const int row = rg + i * RGN;
          *reinterpret_cast<float4*>(red + (((size_t)ks * RG + row) * U + u) * 4) =
              make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
        }
        __syncthreads();
        if (row_ok) {
#pragma unroll
          for (int s = 0; s < kSplit; ++s) {
            const float4 p = *reinterpret_cast<const float4*>(red + (((size_t)s * RG + r) * U + u) * 4);
            gate[0] += p.x; gate[1] += p.y; gate[2] += p.z; gate[3] += p.w;
          }
          const float i_g = sigmoid_f(gate[0]);
          const float f_g = sigmoid_f(gate[1]);
          const float g_g = tanhf(gate[2]);
          const float o_g = sigmoid_f(gate[3]);
          const float c_new = f_g * c_old + i_g * g_g;
          const float h_new = o_g * tanhf(c_new);
          h_next[off] = m > 0.0f ? h_new : h_old;
          *c_ptr = m > 0.0f ? c_new : c_old;
          if (l == L - 1) outs[((size_t)t * N) * H + off] = h_new * m;
        }
      }
    }
    grid.sync();
  }

  // Final h of the units this block owns (written by these same threads).
  const float* h_last = hbuf + (size_t)(F & 1) * L * NH;
  for (int l = 0; l < L; ++l) {
    for (int n0 = 0; n0 < N; n0 += RG) {
      const int n = n0 + r;
      if (n < N) {
        const size_t off = (size_t)l * NH + (size_t)n * H + j;
        h_final[off] = h_last[off];
      }
    }
  }
}

size_t shared_bytes(int U, int H, int L) {
  const int rg = kThreads / U;
  return sizeof(float) * ((size_t)(2 * L - 1) * H * U * 4 + (size_t)(L - 1) * U * 4 +
                          2 * (size_t)rg * (tile_k(U) + 4));
}

template <int U, bool kWave>
int launch(const float* x0_proj, const float* mask, const float* w_hh, const float* w_ih_up,
           const float* b_up, float* outs, float* hbuf, float* c_state, float* h_final, int F,
           int N, int H, int L, int n_sms, cudaStream_t stream) {
  const size_t smem = shared_bytes(U, H, L);
  int max_smem = 0;
  cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, 0);
  if (smem > (size_t)max_smem) return kErrSharedTooLarge;
  auto kernel = lstm_stack_kernel<U, kWave>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = H / U;
  if (per_sm * n_sms < blocks) return kErrGridTooLarge;
  void* args[] = {(void*)&x0_proj, (void*)&mask, (void*)&w_hh,  (void*)&w_ih_up,
                  (void*)&b_up,    (void*)&outs, (void*)&hbuf,  (void*)&c_state,
                  (void*)&h_final, (void*)&F,    (void*)&N,     (void*)&H,
                  (void*)&L};
  err = cudaLaunchCooperativeKernel((void*)kernel, dim3(blocks), dim3(kThreads), args, smem,
                                    stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Units per block for hidden size H on this card: the smallest power of two
// that divides H and gives at most one block per SM.  0 if there is none.
int lstm_stack_units(int H) {
  int dev = 0, n_sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n_sms, cudaDevAttrMultiProcessorCount, dev);
  for (int U = 1; U <= 8; U *= 2) {
    if (H % U == 0 && H / U <= n_sms) return U;
  }
  return 0;
}

}  // extern "C"

namespace {

template <bool kWave>
int forward(const float* x0_proj, const float* mask, const float* w_hh, const float* w_ih_up,
            const float* b_up, float* outs, float* hbuf, float* c_state, float* h_final, int F,
            int N, int H, int L, void* stream) {
  if (F <= 0 || N <= 0 || H <= 0 || L <= 0 || H % 4 != 0) return kErrBadShape;
  if (L > 1 && (w_ih_up == nullptr || b_up == nullptr)) return kErrBadShape;
  int dev = 0, n_sms = 0, coop = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n_sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (!coop) return kErrNoCooperative;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (lstm_stack_units(H)) {
    case 1: return launch<1, kWave>(x0_proj, mask, w_hh, w_ih_up, b_up, outs, hbuf, c_state, h_final, F, N, H, L, n_sms, s);
    case 2: return launch<2, kWave>(x0_proj, mask, w_hh, w_ih_up, b_up, outs, hbuf, c_state, h_final, F, N, H, L, n_sms, s);
    case 4: return launch<4, kWave>(x0_proj, mask, w_hh, w_ih_up, b_up, outs, hbuf, c_state, h_final, F, N, H, L, n_sms, s);
    case 8: return launch<8, kWave>(x0_proj, mask, w_hh, w_ih_up, b_up, outs, hbuf, c_state, h_final, F, N, H, L, n_sms, s);
    default: return kErrGridTooLarge;
  }
}

}  // namespace

extern "C" {

// Runs the whole stack over all F steps in one cooperative launch on `stream`.
// hbuf (2, L, N, H) must hold h0 in its first half and c_state (L, N, H) must
// hold c0; on return outs, h_final and c_state (= cF) are written (stream
// ordered).  Returns 0, a cudaError_t value, or a negative code above.
int lstm_stack_forward(const float* x0_proj, const float* mask, const float* w_hh,
                       const float* w_ih_up, const float* b_up, float* outs, float* hbuf,
                       float* c_state, float* h_final, int F, int N, int H, int L,
                       void* stream) {
  return forward<false>(x0_proj, mask, w_hh, w_ih_up, b_up, outs, hbuf, c_state, h_final, F, N,
                        H, L, stream);
}

// The same stack, the same operands and results, in the wavefront schedule:
// F + L - 1 grid barriers.  Needs L >= 2 (at one layer the schedules are one).
int lstm_wavefront_forward(const float* x0_proj, const float* mask, const float* w_hh,
                           const float* w_ih_up, const float* b_up, float* outs, float* hbuf,
                           float* c_state, float* h_final, int F, int N, int H, int L,
                           void* stream) {
  if (L < 2) return kErrBadShape;
  return forward<true>(x0_proj, mask, w_hh, w_ih_up, b_up, outs, hbuf, c_state, h_final, F, N,
                       H, L, stream);
}

}  // extern "C"
