// K2's fp32 route (attention_bwd.cu and attention_fp32.cuh have its
// design): the rows and column kernels on attention_fp32.cuh's tiles, in a
// translation unit of their own so that their head-dim instantiations
// compile beside K2's bf16 kernels (_build.py links both into K2's
// library).

#include "attention_fp32.cuh"

namespace merlot {
namespace f32 {

// ---------------------------------------------------------------------------
// fp32 kernels on attention_fp32.cuh's tiles, from K1's saved row max and sum

// The fp32 kernels' ring has one stage, so that two blocks (16 warps, the
// registers capped at 128 a thread) share an SM where their shared memory
// allows it: on the H100 at Grover training's shape that beat two stages
// with one block. (One loop for S and dP, in place of two, was slower.)
constexpr int kBwdStages = 1;

// blocks per SM an fp32 kernel's registers are capped for: 2 where two
// blocks' shared memory fits, else 1 (no cap, no spills for nothing)
__host__ __device__ constexpr int bwd_blocks(size_t smem) {
  return 2 * (smem + 1024) <= 228 * 1024 ? 2 : 1;
}

// Q, dO, kBwdStages x (K, V), the dS tile, the load list
template <int DP>
__host__ __device__ constexpr size_t rows_f32_smem() {
  return sizeof(float) * ((2 + 2 * kBwdStages) * f32::tile_floats(DP) + f32::kPFloats) +
         sizeof(int) * f32::kListInts;
}

// one block per (64 q rows, head, batch element): two passes over the K/V
// tiles, the first for D, the second for dS (through shared memory) and
// dQ += dS . K
template <int DP>
__global__ void __launch_bounds__(f32::kThreads, bwd_blocks(rows_f32_smem<DP>()))
    attention_bwd_rows_f32(const BwdF32Args a) {
  using namespace f32;
  constexpr int NC = DP / 16, TF = tile_floats(DP), kStages = kBwdStages;
  extern __shared__ float4 smem4[];
  float* s_q = reinterpret_cast<float*>(smem4);
  float* s_do = s_q + TF;
  float* s_ring = s_do + TF;  // stage st: K at 2 st, V at 2 st + 1
  float* s_ds = s_ring + 2 * kStages * TF;
  int* s_list = reinterpret_cast<int*>(s_ds + kPFloats);  // key tiles: pass 1, then pass 2

  const int n_qt = gridDim.x, qt = n_qt - 1 - blockIdx.x;  // the longest causal rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  int tr, tc;
  place(tid, tr, tc);
  const int Sq = a.Sq, Sk = a.Sk, D = a.D, H = a.H;
  const int q0 = qt * kTile, rows = min(kTile, Sq - q0);
  const int n_kt = (Sk + kTile - 1) / kTile;
  const size_t hd = (size_t)H * D, stat0 = ((size_t)b * H + h) * Sq + q0;
  const bool vec = D % 4 == 0;
  const uint8_t* cls = a.cls == nullptr ? nullptr : a.cls + ((size_t)b * n_qt + qt) * n_kt;
  const float* mb = a.mask == nullptr ? nullptr : a.mask + ((size_t)b * Sq + q0) * Sk;
  const float* gb = a.gcol == nullptr ? nullptr : a.gcol + (size_t)b * Sk;
  const float* kb = a.k + (size_t)b * Sk * hd + (size_t)h * D;
  const float* vb = a.v + (size_t)b * Sk * hd + (size_t)h * D;

  float mx[kRM], sm[kRM], rcp[kRM], dd[kRM];
  bool nz = false;  // some real row's p0 != 0: D needs the all-0 tiles
#pragma unroll
  for (int r = 0; r < kRM; ++r) {
    const bool real = tr + kRS * r < rows;
    mx[r] = real ? a.row_max[stat0 + tr + kRS * r] : 0.f;
    sm[r] = real ? a.row_sum[stat0 + tr + kRS * r] : 1.f;
    rcp[r] = __frcp_rn(sm[r]);
    dd[r] = 0.f;
    nz |= real && cls != nullptr && zero_tile_prob(mx[r], sm[r], rcp[r]) != 0.f;
  }
  nz = __syncthreads_or(nz);
  if (tid == 0) {
    int n = 0;
    for (int kt = 0; kt < n_kt; ++kt)
      if (cls == nullptr || cls[kt] != kZero || nz) s_list[n++] = kt;
    s_list[kListInts - 2] = n;
    for (int kt = 0; kt < n_kt; ++kt)
      if (cls == nullptr || cls[kt] != kZero) s_list[n++] = kt;
    s_list[kListInts - 1] = n;
  }
  zero_pad<DP>(s_q, 2 + 2 * kStages, D);
  __syncthreads();
  const int n1 = s_list[kListInts - 2], n_loads = s_list[kListInts - 1];

  auto fetch = [&](int i) {
    if (i < n_loads) {
      const int k0 = s_list[i] * kTile;
      float* dst = s_ring + 2 * (i % kStages) * TF;
      load_tile<DP>(dst, kb + (size_t)k0 * hd, hd, Sk - k0, D, vec);
      load_tile<DP>(dst + TF, vb + (size_t)k0 * hd, hd, Sk - k0, D, vec);
    }
    cp_async_commit();
  };
  const size_t row0 = ((size_t)b * Sq + q0) * hd + (size_t)h * D;
  load_tile<DP>(s_q, a.q + row0, hd, rows, D, vec);
  load_tile<DP>(s_do, a.dout + row0, hd, rows, D, vec);
  for (int i = 0; i < kStages; ++i) fetch(i);

  float dq[kRM][NC];
#pragma unroll
  for (int r = 0; r < kRM; ++r)
#pragma unroll
    for (int c = 0; c < NC; ++c) dq[r][c] = 0.f;
  for (int i = 0; i < n_loads; ++i) {
    cp_async_wait<kStages - 1>();
    __syncthreads();
    const bool pass1 = i < n1;
    const int kt = s_list[i], k0 = kt * kTile;
    // an all-0 tile in pass 1 (a row's p0 != 0): its mask read
    const int c = cls == nullptr ? kOne : cls[kt] == kZero ? kMixed : cls[kt];
    const float* s_k = s_ring + 2 * (i % kStages) * TF;
    float s[kRM][kCN], dp[kRM][kCN];
    dot_tile<DP>(s, s_q, s_k, tr, tc);
    dot_tile<DP>(dp, s_do, s_k + TF, tr, tc);
#pragma unroll
    for (int j = 0; j < kCN; ++j) {
      const int key = k0 + tc + kCS * j;
      const float gt = gb != nullptr && key < Sk ? gcol_term(gb, key, H) : 0.f;
#pragma unroll
      for (int r = 0; r < kRM; ++r) {
        const int row = tr + kRS * r;
        float ds = 0.f;
        if (key < Sk && row < rows) {
          const float m = c == kOne ? 1.f : mb[(size_t)row * Sk + key];
          const float x = s[r][j] * a.scale;
          const float p = prob32(c == kOne ? x : mask_score(x, m), mx[r], sm[r], rcp[r]);
          const float g = dp[r][j] + gt;
          if (pass1) {
            dd[r] += g * p;
          } else {
            ds = p * (g - dd[r]);
            if (c != kOne) ds *= m;
            ds *= a.scale;
          }
        }
        if (!pass1) s_ds[row * kPLd + tc + kCS * j] = ds;
      }
    }
    if (!pass1) {
      __syncthreads();
      acc_tile<DP>(dq, s_ds, s_k, tr, tc);
    }
    __syncthreads();
    fetch(i + kStages);
    if (i + 1 == n1) {
      // D of each row: its 16 threads' sums (s_ds is free until pass 2)
      row_combine(dd, Sum(), s_ds, tr, tc);
      if (tc == 0)
#pragma unroll
        for (int r = 0; r < kRM; ++r)
          if (tr + kRS * r < rows) a.row_d[stat0 + tr + kRS * r] = dd[r];
    }
  }

  float* ob = a.dq + row0;
#pragma unroll
  for (int r = 0; r < kRM; ++r) {
    if (tr + kRS * r >= rows) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = tc * NC + c;
      if (col < D) ob[(size_t)(tr + kRS * r) * hd + col] = dq[r][c];
    }
  }
}

// K and V, kBwdStages x (Q, dO), the P^T and dS^T tiles, the load list,
// the q tiles' p0 flags
template <int DP>
__host__ __device__ constexpr size_t cols_f32_smem() {
  return sizeof(float) * ((2 + 2 * kBwdStages) * f32::tile_floats(DP) + 2 * f32::kPFloats) +
         sizeof(int) * (f32::kListInts + f32::kMaxTiles);
}

// one block per (64 keys, head, batch element) with its K and V resident:
// walks the q tiles, S^T and dP^T in registers, P^T and dS^T through shared
// memory, dV += P^T . dO and dK += dS^T . Q in registers
template <int DP>
__global__ void __launch_bounds__(f32::kThreads, bwd_blocks(cols_f32_smem<DP>()))
    attention_bwd_cols_f32(const BwdF32Args a) {
  using namespace f32;
  constexpr int NC = DP / 16, TF = tile_floats(DP), kStages = kBwdStages;
  extern __shared__ float4 smem4[];
  float* s_k = reinterpret_cast<float*>(smem4);
  float* s_v = s_k + TF;
  float* s_ring = s_v + TF;  // stage st: Q at 2 st, dO at 2 st + 1
  float* s_pt = s_ring + 2 * kStages * TF;
  float* s_dst = s_pt + kPFloats;
  int* s_list = reinterpret_cast<int*>(s_dst + kPFloats);
  int* s_nz = s_list + kListInts;  // [q tile]: some real row's p0 != 0

  const int kt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  int tr, tc;
  place(tid, tr, tc);
  const int Sq = a.Sq, Sk = a.Sk, D = a.D, H = a.H;
  const int k0 = kt * kTile, n_kt = gridDim.x;
  const int n_qt = (Sq + kTile - 1) / kTile;
  const size_t hd = (size_t)H * D, stat_b = ((size_t)b * H + h) * Sq;
  const bool vec = D % 4 == 0;
  const uint8_t* cls = a.cls == nullptr ? nullptr : a.cls + (size_t)b * n_qt * n_kt + kt;

  for (int t = tid; t < n_qt; t += kThreads) s_nz[t] = 0;
  zero_pad<DP>(s_k, 2 + 2 * kStages, D);
  __syncthreads();
  if (cls != nullptr)
    for (int r = tid; r < Sq; r += kThreads) {
      const float sum = a.row_sum[stat_b + r];
      if (zero_tile_prob(a.row_max[stat_b + r], sum, __frcp_rn(sum)) != 0.f)
        atomicOr(&s_nz[r / kTile], 1);
    }
  __syncthreads();
  // the q tiles: those whose tile is not all 0, and the others of a q tile
  // with p0 != 0 (dV takes their P)
  if (tid == 0) {
    int n = 0;
    for (int qt = 0; qt < n_qt; ++qt)
      if (cls == nullptr || cls[(size_t)qt * n_kt] != kZero || s_nz[qt]) s_list[n++] = qt;
    s_list[kListInts - 1] = n;
  }
  __syncthreads();
  const int n_loads = s_list[kListInts - 1];

  auto fetch = [&](int i) {
    if (i < n_loads) {
      const int q0 = s_list[i] * kTile;
      const size_t row0 = ((size_t)b * Sq + q0) * hd + (size_t)h * D;
      float* dst = s_ring + 2 * (i % kStages) * TF;
      load_tile<DP>(dst, a.q + row0, hd, Sq - q0, D, vec);
      load_tile<DP>(dst + TF, a.dout + row0, hd, Sq - q0, D, vec);
    }
    cp_async_commit();
  };
  const size_t key0 = ((size_t)b * Sk + k0) * hd + (size_t)h * D;
  load_tile<DP>(s_k, a.k + key0, hd, Sk - k0, D, vec);
  load_tile<DP>(s_v, a.v + key0, hd, Sk - k0, D, vec);
  for (int i = 0; i < kStages; ++i) fetch(i);

  float gt[kRM];  // g_colsum / H at this thread's keys
#pragma unroll
  for (int r = 0; r < kRM; ++r) {
    const int key = k0 + tr + kRS * r;
    gt[r] = a.gcol != nullptr && key < Sk ? gcol_term(a.gcol + (size_t)b * Sk, key, H) : 0.f;
  }
  float dv[kRM][NC], dk[kRM][NC];
#pragma unroll
  for (int r = 0; r < kRM; ++r)
#pragma unroll
    for (int c = 0; c < NC; ++c) dv[r][c] = dk[r][c] = 0.f;

  for (int i = 0; i < n_loads; ++i) {
    cp_async_wait<kStages - 1>();
    __syncthreads();
    const int qt = s_list[i], q0 = qt * kTile, rows = min(kTile, Sq - q0);
    const int c = cls == nullptr ? kOne : cls[(size_t)qt * n_kt] == kZero ? kMixed
                                                                        : cls[(size_t)qt * n_kt];
    const float* s_q = s_ring + 2 * (i % kStages) * TF;
    const float* s_do = s_q + TF;
    // the stats of this thread's q rows tc + 16 j
    float mx[kCN], sm[kCN], rcp[kCN], dd[kCN];
#pragma unroll
    for (int j = 0; j < kCN; ++j) {
      const bool real = tc + kCS * j < rows;
      const size_t r = stat_b + q0 + tc + kCS * j;
      mx[j] = real ? a.row_max[r] : 0.f;
      sm[j] = real ? a.row_sum[r] : 1.f;
      dd[j] = real ? a.row_d[r] : 0.f;
      rcp[j] = __frcp_rn(sm[j]);
    }
    float s[kRM][kCN], dp[kRM][kCN];  // [key tr + 8 i][q row tc + 16 j]
    dot_tile<DP>(s, s_k, s_q, tr, tc);
    dot_tile<DP>(dp, s_v, s_do, tr, tc);
    const float* mq = a.mask == nullptr ? nullptr : a.mask + ((size_t)b * Sq + q0) * Sk;
#pragma unroll
    for (int r = 0; r < kRM; ++r)
#pragma unroll
      for (int j = 0; j < kCN; ++j) {
        const int key = k0 + tr + kRS * r, row = tc + kCS * j;
        float p = 0.f, ds = 0.f;
        if (key < Sk && row < rows) {
          const float m = c == kOne ? 1.f : mq[(size_t)row * Sk + key];
          const float x = s[r][j] * a.scale;
          p = prob32(c == kOne ? x : mask_score(x, m), mx[j], sm[j], rcp[j]);
          ds = p * ((dp[r][j] + gt[r]) - dd[j]);
          if (c != kOne) ds *= m;
          ds *= a.scale;
        }
        s_pt[(tr + kRS * r) * kPLd + row] = p;
        s_dst[(tr + kRS * r) * kPLd + row] = ds;
      }
    __syncthreads();
    acc_tile<DP>(dv, s_pt, s_do, tr, tc);
    acc_tile<DP>(dk, s_dst, s_q, tr, tc);
    __syncthreads();
    fetch(i + kStages);
  }

#pragma unroll
  for (int r = 0; r < kRM; ++r) {
    if (k0 + tr + kRS * r >= Sk) continue;
    const size_t off = key0 + (size_t)(tr + kRS * r) * hd;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = tc * NC + c;
      if (col < D) {
        a.dv[off + col] = dv[r][c];
        a.dk[off + col] = dk[r][c];
      }
    }
  }
}

template <int DP>
cudaError_t launch_bwd_f32_dp(const BwdF32Args& a, int B, cudaStream_t st) {
  const dim3 rgrid(f32::n_tiles(a.Sq), a.H, B), cgrid(f32::n_tiles(a.Sk), a.H, B);
  cudaError_t err = launch(attention_bwd_rows_f32<DP>, rgrid, f32::kThreads,
                           rows_f32_smem<DP>(), st, a);
  if (err != cudaSuccess) return err;
  return launch(attention_bwd_cols_f32<DP>, cgrid, f32::kThreads, cols_f32_smem<DP>(), st, a);
}

cudaError_t launch_bwd_f32(const BwdF32Args& a, int B, cudaStream_t st) {
  switch (f32::pad16(a.D)) {
    case 16: return launch_bwd_f32_dp<16>(a, B, st);
    case 32: return launch_bwd_f32_dp<32>(a, B, st);
    case 48: return launch_bwd_f32_dp<48>(a, B, st);
    case 64: return launch_bwd_f32_dp<64>(a, B, st);
    case 80: return launch_bwd_f32_dp<80>(a, B, st);
    case 96: return launch_bwd_f32_dp<96>(a, B, st);
    case 112: return launch_bwd_f32_dp<112>(a, B, st);
    case 128: return launch_bwd_f32_dp<128>(a, B, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace f32
}  // namespace merlot
