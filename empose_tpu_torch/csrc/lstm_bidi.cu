// Bidirectional LSTM layer forward for Hopper (sm_90a): both directions in
// one cooperative launch, or one direction per launch where the two do not
// fit on the card at once.
//
// Replaces the Pallas TPU kernel empose_tpu/ops/lstm_kernel.py::_pallas_bidi
// (body _make_bidi_kernel): one bidirectional LSTM layer at inference, both
// directions over F steps, gates in torch order (i, f, g, o).  Each
// direction's gate input is its hoisted projection x_proj[:, d] (both biases
// folded in, computed outside as one GEMM per direction); the backward one is
// projected from the input reversed per sample by length, so one mask serves
// both directions and the backward outputs come out in reversed time.  Where
// mask == 0 the (h, c) state is selected, frozen bit for bit, and the step's
// output is h_new * mask.
//
// What bounds it on this card.  The recurrence is serial in time, and every
// step needs both directions' W_hh (8.4 MB at H=512).  Three things bound a
// call:
//   * the fp32 FMA work, 2*2*F*N*H*4H operations (0.064 ms at F=16, N=64,
//     H=512: about 4 us per step);
//   * F grid barriers, one per step for both directions (1.5-2.8 us each on
//     an H100), or two sets of F where the directions run one per launch;
//   * the step's exchange buffer: every block reads all N rows of its
//     direction's h[t-1] (N*H*4 bytes: 128 KB at N=64, H=512) from L2 just
//     after the barrier, so it cannot be prefetched.
// The design is the training forward sweep's (csrc/lstm_train.cu,
// lstm_train_fwd_kernel), which runs the same recurrence for one direction:
//   * Grid.  Each block owns U consecutive hidden units j of ONE direction d
//     and keeps their four gate columns {j, H+j, 2H+j, 3H+j} of W_hh[d]
//     resident in shared memory, laid out so that neighbouring threads read
//     neighbouring float4.  U=8 wherever 8 divides H (U=4 where H % 8 == 4):
//     where 2H/U blocks fit on the SMs beside their columns (H=512: 128
//     blocks of 64 KB of columns), both directions share one grid and one
//     barrier per step; otherwise (H=1024: 128 KB of columns) the wrapper
//     launches the same kernel once per direction, each with H/U blocks.
//     U=4 with two blocks per SM at H=512 (256 blocks, 128 registers a
//     thread, W_hh read from shared memory) was slower at every N on an H100
//     (PERF.md).
//   * Staging.  Step t copies all N rows of the block's direction's h[t-1]
//     by 16-byte cp.async.cg copies (through L2, never a stale L1), one copy
//     group per chunk of 16 rows, from a 128-byte boundary; the pass over
//     chunk c waits only for chunk c's group, so its FMAs run while the later
//     chunks land.  Where the rows do not fit beside the columns (N > 81 at
//     H=512, U=8), the chunks cycle through a ring of 16-row slots, the next
//     chunks in flight while the current one's FMAs run; with one slot
//     (H=1024, N > 24) a chunk is copied only once every thread is done with
//     the one before.  So the shared memory does not grow with N, and any N
//     runs.  The launch plan (ops/lstm_kernel.py::lstm_bidi_plan) sizes it.
//   * FMAs.  Warp (unit pair, row group) multiplies its rows of the chunk by
//     the eight gate columns of its two units, lane l over the float4
//     columns l, l + 32, ... of H, with W_hh of the first two of them held
//     in registers for the whole sweep (half of it at H=512) and the rest
//     read from the resident columns: a staged h value is read from shared
//     memory once per unit pair.  At U=8 a warp has 8 rows of each chunk and
//     multiplies them as one 8-row register tile of 64 sums, so the sums are
//     reduced and the cell run once per chunk (4-row tiles, two per chunk,
//     were slower at N=64 on an H100); fewer rows take 4, 2 and 1-row
//     tiles: no FMA and no shared load falls on a row beyond N.  The partial
//     sums meet in a fixed-order warp reduce-scatter that leaves each lane
//     with the whole sums of one or two (row, unit, gate): no atomics and no
//     shared memory, so two launches on the same inputs give the same bits,
//     and a chunk needs one __syncthreads.
//   * The cell, in the warp.  Each lane reads its step operands (x_proj's
//     gate column, mask, the carry c) from device memory before its FMAs,
//     which hide their latency, adds x_proj to its sum and applies its gate's
//     nonlinearity; the first lane of each (row, unit) gathers the four gates
//     by shuffles and writes h[t], c and the output.  h0 and c0 are read in
//     place at the first step: no copy before the launch.
//   * One grid barrier per step, none after the last.
// fp32 FMAs on the CUDA cores, no tensor cores (the fp32 parity mode).
// The grid must be co-resident for the barrier: lstm_bidi_prepare sets the
// kernel's shared memory and checks its occupancy once per device, the
// wrapper keeps the grid within the SMs, and lstm_bidi_forward only launches
// (cudaLaunchCooperativeKernel): no attribute or occupancy query per call,
// so a call can be captured in a CUDA graph.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPassRows = 16;  // rows of h[t-1] per staged chunk

// Error codes beside cudaError_t values (which are >= 0); the same values
// as lstm_stack.cu.
constexpr int kErrGridTooLarge = -1;
constexpr int kErrNoCooperative = -3;
constexpr int kErrBadShape = -4;

__device__ __forceinline__ float sigmoid_f(float x) { return 1.0f / (1.0f + expf(-x)); }

__device__ __forceinline__ float component(const float4& v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

__host__ __device__ constexpr size_t round32(size_t x) { return (x + 31) / 32 * 32; }

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Waits until at most `pending` of this thread's newest copy groups are in
// flight (exactly for up to 7; for more it waits until 7 are, which is safe).
__device__ __forceinline__ void cp_async_wait_upto(int pending) {
  switch (pending) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    case 6: cp_async_wait<6>(); break;
    default: cp_async_wait<7>(); break;
  }
}

// Shared memory of a block (floats), in this order:
//   w_s  [4][U][H], to 128 bytes    the block's gate columns of W_hh[d]: the
//                                   float4 of unit u's four gates at row
//                                   k = 4c + q sits at (q * U + u) * H + 4c
//   h_s  [stage_rows][H]            the staged rows of h[t-1], from a
//                                   128-byte boundary: all N, or a ring of
//                                   stage_rows / 16 chunk slots
// The same formula as ops/lstm_kernel.py::bidi_smem_bytes.
__host__ __device__ constexpr size_t smem_floats(int U, int H, int stage_rows) {
  return round32((size_t)4 * U * H) + (size_t)stage_rows * H;
}

// Units a warp multiplies at once (a staged h value read from shared memory
// serves both units' FMAs), and float4 columns of H per lane whose W_hh
// lives in registers for the whole sweep: half of W_hh at H=512; with four,
// the 64 sums of an 8-row tile no longer fit in 255 registers without spills.
constexpr int kUnitPair = 2;
constexpr int kRegCols = 2;

// The sums over the warp's 32 lanes of the CNT <= 32 values v[0..CNT-1],
// scattered over the lanes: each stage at lane offset O hands half of the
// values a lane still holds to lane ^ O and adds the other half's, so after
// log2(CNT) stages lane l holds in v[0] the sum of value l / (32 / CNT); the
// offsets left add whole values.  The same lanes add in the same order every
// launch.
template <int CNT, int O>
__device__ __forceinline__ void warp_reduce_scatter(float* v, int lane) {
  if constexpr (O > 0) {
    if constexpr (CNT > 1) {
      constexpr int kHalf = CNT / 2;
      const bool up = (lane & O) != 0;
#pragma unroll
      for (int i = 0; i < kHalf; ++i) {
        const float send = up ? v[i] : v[i + kHalf];
        const float keep = up ? v[i + kHalf] : v[i];
        v[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
      }
      warp_reduce_scatter<kHalf, O / 2>(v, lane);
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], O);
      warp_reduce_scatter<1, O / 2>(v, lane);
    }
  }
}

// What the pieces of a step share (pointers already at step t and the
// block's direction d).
struct Step {
  const float* x_t;     // x_proj[t, d]  (N, 4H)
  const float* mask_t;  // mask[t]       (N)
  const float* c_prev;  // c0[d] at t = 0, else c_out[d]  (N, H)
  float* c_next;        // c_out[d]      (N, H)
  float* h_next;        // h[t] of direction d  (N, H)
  float* out_t;         // outs[t, d]    (N, H)
  int H, j0;
};

// One warp's piece of a step: NP staged rows (`rows`, stride H; global rows
// n0 ...) times the four gate columns of its UP units u0, u0 + 1.  Lane l
// multiplies the float4 columns l, l + 32, ... of H (W_hh of the first RC of
// them in registers).  The warp's V = 4 UP NP <= 64 sums, value (row r, unit
// ui, gate g) being (r UP + ui) 4 + g, are scattered over the lanes: where
// V <= 32 lane l holds value l / kC (kC = 32 / V lanes hold each), where
// V = 64 it holds values 2l and 2l + 1.  Each lane adds x_proj's columns to
// its sums and applies their gates' nonlinearities, and the first lane of
// each (row, unit) gathers the four gates and writes its h, c and output.
template <int U, int NP>
__device__ __forceinline__ void step_piece(const Step& p, const float* rows, int n0,
                                           const float4 (&wreg)[kUnitPair][kRegCols][4],
                                           const float* w_s, int u0, int lane) {
  constexpr int UP = kUnitPair, RC = kRegCols;
  constexpr int V = 4 * UP * NP;
  constexpr int kPer = V > 32 ? V / 32 : 1;  // sums a lane ends with
  constexpr int kC = V < 32 ? 32 / V : 1;    // lanes holding the same sum
  constexpr int kCell = 4 / kPer * kC;       // lanes holding one (row, unit)'s four gates
  static_assert(V <= 64, "a piece holds at most 64 sums");
  const int H = p.H;
  const int C4 = H / 4;
  const int idx = lane / kC * kPer;  // the lane's first value
  const int g = idx % 4;             // its gate; the lane's value k has gate g + k
  const int u = u0 + idx / 4 % UP;
  const int r_own = idx / (4 * UP);
  const int n = n0 + r_own;
  const int j = p.j0 + u;
  const bool lead = lane % kCell == 0;

  // The cell's operands, read before the FMAs so that their latency hides
  // behind them; the old h of a masked row is its staged row.
  float x[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) x[k] = __ldg(p.x_t + (size_t)n * 4 * H + (g + k) * H + j);
  float m = 0.0f, c_old = 0.0f, h_old = 0.0f;
  if (lead) {
    h_old = rows[(size_t)r_own * H + j];
    m = __ldg(p.mask_t + n);
    c_old = p.c_prev[(size_t)n * H + j];
  }

  const float4* r4 = reinterpret_cast<const float4*>(rows);
  float acc[V];
#pragma unroll
  for (int i = 0; i < V; ++i) acc[i] = 0.0f;
  auto fma_rows = [&](const float4(&w)[UP][4], int c) {
#pragma unroll
    for (int r = 0; r < NP; ++r) {
      const float4 h = r4[r * C4 + c];
#pragma unroll
      for (int ui = 0; ui < UP; ++ui)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float a = component(h, q);
          float* out = acc + (r * UP + ui) * 4;
          out[0] = fmaf(a, w[ui][q].x, out[0]);
          out[1] = fmaf(a, w[ui][q].y, out[1]);
          out[2] = fmaf(a, w[ui][q].z, out[2]);
          out[3] = fmaf(a, w[ui][q].w, out[3]);
        }
    }
  };
#pragma unroll
  for (int i = 0; i < RC; ++i) {
    if (lane + 32 * i < C4) {
      float4 w[UP][4];
#pragma unroll
      for (int ui = 0; ui < UP; ++ui)
#pragma unroll
        for (int q = 0; q < 4; ++q) w[ui][q] = wreg[ui][i][q];
      fma_rows(w, lane + 32 * i);
    }
  }
  const float4* w4 = reinterpret_cast<const float4*>(w_s);
  for (int c = lane + 32 * RC; c < C4; c += 32) {
    float4 w[UP][4];
#pragma unroll
    for (int ui = 0; ui < UP; ++ui)
#pragma unroll
      for (int q = 0; q < 4; ++q) w[ui][q] = w4[(q * U + u0 + ui) * C4 + c];
    fma_rows(w, c);
  }
  warp_reduce_scatter<V, 16>(acc, lane);

  float act[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const float pre = x[k] + acc[k];
    act[k] = g + k == 2 ? tanhf(pre) : sigmoid_f(pre);
  }
  // Gate q of the lane's (row, unit) is value q % kPer of lane base + q / kPer * kC.
  const int base = lane / kCell * kCell;
  float gate[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) gate[q] = __shfl_sync(0xffffffffu, act[q % kPer], base + q / kPer * kC);
  if (lead) {
    const float c_new = gate[1] * c_old + gate[0] * gate[2];
    const float h_new = gate[3] * tanhf(c_new);
    const size_t off = (size_t)n * H + j;
    p.h_next[off] = m > 0.0f ? h_new : h_old;
    p.c_next[off] = m > 0.0f ? c_new : c_old;
    p.out_t[off] = h_new * m;
  }
}

// Block b serves direction d0 + b / (H / U) and its units j0 = (b % (H / U))
// * U, ...  Warps: unit pair warp % (U / 2) (units u0, u0 + 1), row group
// warp / (U / 2); the rows of a 16-row chunk are split over the row groups,
// U rows each, which a warp multiplies as one tile where all of them exist,
// else in tiles of 4, 2 and 1 rows.  Chunk c lies in slot c % slots of h_s
// (slots = stage_rows / 16 rounded up; all chunks where stage_rows == N).
// h of step t goes to hbuf[(t + 1) & 1], read at step t + 1 (h0 in place at
// step 0); c is kept in c_out, each element read and written by the same
// lane (c0 in place at step 0).
template <int U>
__global__ void __launch_bounds__(kThreads, 1)
lstm_bidi_kernel(const float* __restrict__ x_proj,  // (F, 2, N, 4H)
                 const float* __restrict__ mask,    // (F, N)
                 const float* __restrict__ w_hh,    // (2, H, 4H)
                 const float* __restrict__ h0,      // (2, N, H)
                 const float* __restrict__ c0,      // (2, N, H)
                 float* __restrict__ outs,          // (F, 2, N, H)
                 float* hbuf,                       // (2, 2, N, H)
                 float* c_out,                      // (2, N, H): cF at the end
                 int F, int N, int H, int d0, int stage_rows) {
  constexpr int UP = kUnitPair, RC = kRegCols;
  constexpr int kRowsW = kPassRows * U / UP / kWarps;  // rows of a chunk per warp: U
  static_assert(U == 4 || U == 8, "a warp's rows of a chunk are one tile of at most 64 sums");
  extern __shared__ __align__(16) float smem[];
  const int blocks_per_dir = H / U;
  const int d = d0 + blockIdx.x / blocks_per_dir;
  const int j0 = (blockIdx.x % blocks_per_dir) * U;
  const size_t NH = (size_t)N * H;
  float* w_s = smem;
  float* h_s = w_s + round32((size_t)4 * U * H);

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int u0 = warp % (U / UP) * UP;
  const int row_lo = warp / (U / UP) * kRowsW;
  const int C4 = H / 4;
  const int n_chunks = (N + kPassRows - 1) / kPassRows;
  const int slots = (stage_rows + kPassRows - 1) / kPassRows;
  const int first = min(slots, n_chunks);  // chunks issued at the start of a step
  cg::grid_group grid = cg::this_grid();

  const float* w_d = w_hh + (size_t)d * H * 4 * H;
  for (int idx = tid; idx < 4 * U * H; idx += kThreads) {
    const int qu = idx / H;
    const int k = (idx % H) / 4 * 4 + qu / U;
    w_s[idx] = w_d[(size_t)k * 4 * H + (idx % 4) * H + j0 + qu % U];
  }
  __syncthreads();
  float4 wreg[UP][RC][4];
  const float4* w4 = reinterpret_cast<const float4*>(w_s);
#pragma unroll
  for (int ui = 0; ui < UP; ++ui)
#pragma unroll
    for (int i = 0; i < RC; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        wreg[ui][i][q] = lane + 32 * i < C4 ? w4[(q * U + u0 + ui) * C4 + lane + 32 * i]
                                            : make_float4(0.f, 0.f, 0.f, 0.f);

  for (int t = 0; t < F; ++t) {
    const float* h_prev = t == 0 ? h0 + d * NH : hbuf + ((size_t)(t & 1) * 2 + d) * NH;
    Step p;
    p.x_t = x_proj + ((size_t)t * 2 + d) * N * 4 * H;
    p.mask_t = mask + (size_t)t * N;
    p.c_prev = (t == 0 ? c0 : c_out) + d * NH;
    p.c_next = c_out + d * NH;
    p.h_next = hbuf + ((size_t)((t + 1) & 1) * 2 + d) * NH;
    p.out_t = outs + ((size_t)t * 2 + d) * NH;
    p.H = H;
    p.j0 = j0;

    // Every chunk that has a slot, one copy group each.
    auto issue = [&](int c) {
      const int r0 = c * kPassRows;
      const int cr = min(kPassRows, N - r0);
      float* dst = h_s + (size_t)(c % slots) * kPassRows * H;
      const float* src = h_prev + (size_t)r0 * H;
      for (int i = 4 * tid; i < cr * H; i += 4 * kThreads) cp_async16(dst + i, src + i);
      cp_async_commit();
    };
    for (int c = 0; c < first; ++c) issue(c);
    int groups = first;

    for (int c = 0; c < n_chunks; ++c) {
      if (slots == 1 && c > 0) {  // a one-slot ring: chunk c goes where chunk c - 1 was read
        __syncthreads();          // every thread is done with chunk c - 1
        issue(c);
        ++groups;
      }
      cp_async_wait_upto(groups - c - 1);  // chunk c has landed
      __syncthreads();  // ... for every thread, and every thread is done with chunk c - 1
      if (slots > 1 && c > 0 && c - 1 + slots < n_chunks) {
        issue(c - 1 + slots);  // into chunk c - 1's slot, while chunk c is read
        ++groups;
      }
      const int r0 = c * kPassRows;
      const float* st = h_s + (size_t)(c % slots) * kPassRows * H;
      int lo = row_lo;
      int nr = max(0, min(kRowsW, N - r0 - lo));
      if (nr == kRowsW) {
        step_piece<U, kRowsW>(p, st + (size_t)lo * H, r0 + lo, wreg, w_s, u0, lane);
        nr = 0;
      }
      if constexpr (kRowsW > 4) {
        if (nr & 4) {
          step_piece<U, 4>(p, st + (size_t)lo * H, r0 + lo, wreg, w_s, u0, lane);
          lo += 4;
        }
      }
      if (nr & 2) {
        step_piece<U, 2>(p, st + (size_t)lo * H, r0 + lo, wreg, w_s, u0, lane);
        lo += 2;
      }
      if (nr & 1) step_piece<U, 1>(p, st + (size_t)lo * H, r0 + lo, wreg, w_s, u0, lane);
    }

    if (t + 1 < F) grid.sync();  // every block's rows of h[t] are written
  }
}

// Lets lstm_bidi_kernel<U> use up to max_smem bytes of dynamic shared memory
// and clears *fits unless an SM holds one block of it with that much.
template <int U>
cudaError_t prepare_units(int max_smem, bool* fits) {
  const void* kernel = (const void*)lstm_bidi_kernel<U>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         max_smem);
  int per_sm = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, max_smem);
  if (per_sm < 1) *fits = false;
  return err;
}

template <int U>
int launch(const float* x_proj, const float* mask, const float* w_hh, const float* h0,
           const float* c0, float* outs, float* hbuf, float* c_out, int F, int N, int H,
           int d0, int dirs, int stage_rows, cudaStream_t stream) {
  void* args[] = {(void*)&x_proj, (void*)&mask, (void*)&w_hh,  (void*)&h0,
                  (void*)&c0,     (void*)&outs, (void*)&hbuf,  (void*)&c_out,
                  (void*)&F,      (void*)&N,    (void*)&H,     (void*)&d0,
                  (void*)&stage_rows};
  const size_t smem = sizeof(float) * smem_floats(U, H, stage_rows);
  const cudaError_t err =
      cudaLaunchCooperativeKernel((const void*)lstm_bidi_kernel<U>, dim3(dirs * H / U),
                                  dim3(kThreads), args, smem, stream);
  const cudaError_t last = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : last);
}

}  // namespace

extern "C" {

// Once per device, before the first launch there (and outside any CUDA graph
// capture): checks that the card launches cooperative grids, lets both
// instances use the card's opt-in shared memory per block, and checks that
// an SM holds one block of each with that much.  Writes the SM count and the
// opt-in limit in bytes to info[0..1].  Returns 0, a cudaError_t value, or a
// negative code above.
int lstm_bidi_prepare(int device, int* info) {
  int prev = 0, coop = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return (int)err;
  err = cudaSetDevice(device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&info[0], cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&info[1], cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  bool fits = true;
  if (err == cudaSuccess) err = prepare_units<4>(info[1], &fits);
  if (err == cudaSuccess) err = prepare_units<8>(info[1], &fits);
  cudaSetDevice(prev);
  if (err != cudaSuccess) return (int)err;
  if (!coop) return kErrNoCooperative;
  return fits ? 0 : kErrGridTooLarge;
}

// Runs `dirs` directions (2: both, block b / (H / units) serving direction
// b / (H / units); 1: direction d0 alone) of one bidirectional layer over all
// F steps in one cooperative launch of dirs * H / units blocks on `stream`.
// h0, c0 (2, N, H) are read in place; outs (F, 2, N, H), hbuf (2, 2, N, H)
// and c_out (2, N, H) are written for the launch's directions: h after the
// last step in hbuf[F & 1], c in c_out.  units (8, or 4 where H % 8 == 4),
// stage_rows (N: all rows staged at once; else a multiple of 16 below N, a
// ring of 16-row slots) and smem_bytes are the launch plan's; smem_bytes
// must equal the layout's size.  h0 and hbuf start on a 16-byte boundary.
// Launches only: lstm_bidi_prepare must have run on the current device.
// Returns 0, a cudaError_t value, or a negative code above.
int lstm_bidi_forward(const float* x_proj, const float* mask, const float* w_hh,
                      const float* h0, const float* c0, float* outs, float* hbuf, float* c_out,
                      int F, int N, int H, int units, int d0, int dirs, int stage_rows,
                      int smem_bytes, void* stream) {
  if (F <= 0 || N <= 0 || H <= 0 || H % 4 != 0 || (units != 4 && units != 8) ||
      H % units != 0 || (dirs != 1 && dirs != 2) || d0 < 0 || d0 + dirs > 2 ||
      stage_rows <= 0 || stage_rows > N || (stage_rows != N && stage_rows % kPassRows != 0) ||
      (size_t)smem_bytes != sizeof(float) * smem_floats(units, H, stage_rows))
    return kErrBadShape;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return units == 8
             ? launch<8>(x_proj, mask, w_hh, h0, c0, outs, hbuf, c_out, F, N, H, d0, dirs,
                         stage_rows, s)
             : launch<4>(x_proj, mask, w_hh, h0, c0, outs, hbuf, c_out, F, N, H, d0, dirs,
                         stage_rows, s);
}

}  // extern "C"
