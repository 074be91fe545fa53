// K1's fp32 route (attention_fp32.cuh has its design): the mask's tile
// classifier and the kernel, in a translation unit of their own so that
// its eight head-dim instantiations compile once, beside the other
// sources, and link into K1's, K2's and K3's libraries (_build.py).

#include "attention_fp32.cuh"

namespace merlot {
namespace f32 {

// the class of each 64 x 64 tile of a [Bm, Sq, Sk] mask, [Bm][n_qt][n_kt]:
// its real elements all 0, all 1, or anything else. Grid (n_kt, n_qt, Bm).
__global__ void __launch_bounds__(kThreads)
mask_tile_classes(const float* __restrict__ mask, uint8_t* __restrict__ cls, int Sq, int Sk) {
  const int kt = blockIdx.x, qt = blockIdx.y, b = blockIdx.z;
  const int r0 = qt * kTile, k0 = kt * kTile;
  const int rows = min(kTile, Sq - r0), keys = min(kTile, Sk - k0);
  const float* m = mask + ((size_t)b * Sq + r0) * Sk + k0;
  bool zero = true, one = true;
  for (int i = threadIdx.x; i < kTile * kTile; i += kThreads) {
    const int r = i / kTile, c = i % kTile;
    if (r < rows && c < keys) {
      const float x = m[(size_t)r * Sk + c];
      zero &= x == 0.f;
      one &= x == 1.f;
    }
  }
  zero = __syncthreads_and(zero);
  one = __syncthreads_and(one);
  if (threadIdx.x == 0)
    cls[((size_t)b * gridDim.y + qt) * gridDim.x + kt] = zero ? kZero : one ? kOne : kMixed;
}

static cudaError_t launch_tile_classes(const float* mask, uint8_t* cls, int Bm, int Sq,
                                       int Sk, cudaStream_t st) {
  const dim3 grid(n_tiles(Sk), n_tiles(Sq), Bm);
  mask_tile_classes<<<grid, kThreads, 0, st>>>(mask, cls, Sq, Sk);
  return cudaGetLastError();
}

// Q, kStages x (K, V), the P tile, the load list
template <int DP>
constexpr size_t fwd_smem() {
  return sizeof(float) * ((1 + 2 * kStages) * tile_floats(DP) + kPFloats) +
         sizeof(int) * kListInts;
}

template <int DP>
__global__ void __launch_bounds__(kThreads, 2) attention_fwd_f32(const FwdArgs a) {
  constexpr int NC = DP / 16, TF = tile_floats(DP);
  extern __shared__ float4 smem4[];
  float* s_q = reinterpret_cast<float*>(smem4);
  float* s_ring = s_q + TF;  // stage st: K at 2 st, V at 2 st + 1
  float* s_p = s_ring + 2 * kStages * TF;
  int* s_list = reinterpret_cast<int*>(s_p + kPFloats);  // key tiles: pass 1, then pass 2

  const int n_qt = gridDim.x, qt = n_qt - 1 - blockIdx.x;  // the longest causal rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  int tr, tc;
  place(tid, tr, tc);
  const int Sq = a.Sq, Sk = a.Sk, D = a.D;
  const int q0 = qt * kTile, rows = min(kTile, Sq - q0);
  const int n_kt = (Sk + kTile - 1) / kTile;
  const size_t hd = (size_t)a.H * D;
  const bool vec = D % 4 == 0;
  const uint8_t* cls = a.cls == nullptr ? nullptr
                       : a.cls + ((a.mask_bs != 0 ? (size_t)b : 0) * n_qt + qt) * n_kt;
  const float* mb = a.mask == nullptr ? nullptr : a.mask + b * a.mask_bs + (size_t)q0 * Sk;
  const float* kb = a.k + (size_t)b * Sk * a.kv_ld + (size_t)h * D;
  const float* vb = a.v + (size_t)b * Sk * a.kv_ld + (size_t)h * D;

  // pass 1 visits the tiles that are not all 0 (s_list[0..n1)), and so
  // does pass 2 (s_list[kMaxTiles..]) unless a row's p0 != 0: then pass 2
  // is rebuilt below over every tile, in order
  if (tid == 0) {
    int n = 0;
    for (int kt = 0; kt < n_kt; ++kt)
      if (cls == nullptr || cls[kt] != kZero) s_list[kMaxTiles + n] = s_list[n] = kt, ++n;
    s_list[kListInts - 1] = n;
  }
  zero_pad<DP>(s_q, 1 + 2 * kStages, D);
  __syncthreads();
  const int n1 = s_list[kListInts - 1];
  int n_loads = a.stats_only ? n1 : 2 * n1;

  auto fetch = [&](int i) {  // load i: K of s_list[i], or in pass 2 K and V
    if (i < n_loads) {
      const int k0 = s_list[i < n1 ? i : kMaxTiles + i - n1] * kTile;
      float* dst = s_ring + 2 * (i % kStages) * TF;
      load_tile<DP>(dst, kb + (size_t)k0 * a.kv_ld, a.kv_ld, Sk - k0, D, vec);
      if (i >= n1) load_tile<DP>(dst + TF, vb + (size_t)k0 * a.kv_ld, a.kv_ld, Sk - k0, D, vec);
    }
    cp_async_commit();
  };
  load_tile<DP>(s_q, a.q + ((size_t)b * Sq + q0) * hd + (size_t)h * D, hd, rows, D, vec);
  for (int i = 0; i < kStages; ++i) fetch(i);

  // the rounded, masked score of element (i, j) of the tile at k0 (class c)
  auto score = [&](float s, int c, int i, int key) {
    s *= a.scale;
    return c == kOne || tr + kRS * i >= rows ? s
                                            : mask_score(s, mb[(size_t)(tr + kRS * i) * Sk + key]);
  };

  // pass 1: each thread's running max and rescaled sum for its 8 rows over
  // its 4 keys of each tile; an all-0 tile adds -1e10 at its real keys
  float mx[kRM], sum[kRM], rcp[kRM];
  int zero_keys = 0;
  if (cls != nullptr)
    for (int kt = 0; kt < n_kt; ++kt)
      if (cls[kt] == kZero)
        for (int j = 0; j < kCN; ++j) zero_keys += kt * kTile + tc + kCS * j < Sk;
#pragma unroll
  for (int i = 0; i < kRM; ++i) {
    mx[i] = zero_keys > 0 ? -kMaskPenalty : -INFINITY;
    sum[i] = (float)zero_keys;
  }
  for (int i = 0; i < n1; ++i) {
    cp_async_wait<kStages - 1>();
    __syncthreads();
    const int kt = s_list[i], k0 = kt * kTile, c = cls == nullptr ? kOne : cls[kt];
    float s[kRM][kCN];
    dot_tile<DP>(s, s_q, s_ring + 2 * (i % kStages) * TF, tr, tc);
#pragma unroll
    for (int r = 0; r < kRM; ++r) {
      float v[kCN], m = mx[r];
#pragma unroll
      for (int j = 0; j < kCN; ++j) {
        const int key = k0 + tc + kCS * j;
        v[j] = key < Sk ? score(s[r][j], c, r, key) : -INFINITY;
        m = fmaxf(m, v[j]);
      }
      if (m != mx[r]) {
        sum[r] *= expf(mx[r] - m);
        mx[r] = m;
      }
      if (m != -INFINITY)
#pragma unroll
        for (int j = 0; j < kCN; ++j) sum[r] += expf(v[j] - m);
    }
    __syncthreads();
    fetch(i + kStages);
  }
  // the row's 16 threads combined (s_p is free until pass 2)
  float m[kRM];
#pragma unroll
  for (int r = 0; r < kRM; ++r) m[r] = mx[r];
  row_combine(m, Max(), s_p, tr, tc);
#pragma unroll
  for (int r = 0; r < kRM; ++r) {
    sum[r] = mx[r] == -INFINITY ? 0.f : mx[r] == m[r] ? sum[r] : sum[r] * expf(mx[r] - m[r]);
    mx[r] = m[r];
  }
  row_combine(sum, Sum(), s_p, tr, tc);
  bool nz = false;  // some real row's p0 != 0: pass 2 needs the all-0 tiles
  const bool any_zero = n1 < n_kt;
#pragma unroll
  for (int r = 0; r < kRM; ++r) {
    rcp[r] = __frcp_rn(sum[r]);
    nz |= tr + kRS * r < rows && any_zero && zero_tile_prob(mx[r], sum[r], rcp[r]) != 0.f;
  }
  nz = __syncthreads_or(nz);
  if (a.stats != nullptr && tc == 0) {
    const size_t n = (size_t)gridDim.z * a.H * Sq, r0 = ((size_t)b * a.H + h) * Sq + q0;
    for (int r = 0; r < kRM; ++r)
      if (tr + kRS * r < rows) {
        a.stats[r0 + tr + kRS * r] = mx[r];
        a.stats[n + r0 + tr + kRS * r] = sum[r];
      }
  }
  if (a.stats_only) return;

  float* part = a.colsum_part == nullptr
                    ? nullptr
                    : a.colsum_part + (((size_t)b * a.H + h) * n_qt + qt) * Sk;
  if (nz) {
    // a row is fully masked, or its max is -1e10: pass 2 takes every tile,
    // the all-0 ones with their mask read; the ring restarts on that list
    cp_async_wait<0>();
    __syncthreads();
    if (tid == 0)
      for (int kt = 0; kt < n_kt; ++kt) s_list[kMaxTiles + kt] = kt;
    n_loads = n1 + n_kt;
    __syncthreads();
    for (int i = n1; i < n1 + kStages; ++i) fetch(i);
  } else if (part != nullptr && cls != nullptr) {
    // the skipped tiles' colsum partials are 0
    for (int kt = 0; kt < n_kt; ++kt)
      if (cls[kt] == kZero)
        for (int j = tid; j < kTile && kt * kTile + j < Sk; j += kThreads) part[kt * kTile + j] = 0.f;
  }

  // pass 2: P (0 at keys past Sk and on rows past Sq) into s_p, its column
  // sums, and ctx += P . V
  float o[kRM][NC];
#pragma unroll
  for (int r = 0; r < kRM; ++r)
#pragma unroll
    for (int c = 0; c < NC; ++c) o[r][c] = 0.f;
  for (int i = n1; i < n_loads; ++i) {
    cp_async_wait<kStages - 1>();
    __syncthreads();
    const int kt = s_list[kMaxTiles + i - n1], k0 = kt * kTile;
    const int c = cls == nullptr ? kOne : cls[kt] == kZero ? kMixed : cls[kt];
    const float* s_k = s_ring + 2 * (i % kStages) * TF;
    float s[kRM][kCN];
    dot_tile<DP>(s, s_q, s_k, tr, tc);
#pragma unroll
    for (int r = 0; r < kRM; ++r)
#pragma unroll
      for (int j = 0; j < kCN; ++j) {
        const int key = k0 + tc + kCS * j;
        s_p[(tr + kRS * r) * kPLd + tc + kCS * j] =
            key < Sk && tr + kRS * r < rows ? prob32(score(s[r][j], c, r, key), mx[r], sum[r], rcp[r])
                                           : 0.f;
      }
    __syncthreads();
    if (part != nullptr && tid < kTile && k0 + tid < Sk) {
      float cs = 0.f;
      for (int r = 0; r < kTile; ++r) cs += s_p[r * kPLd + tid];
      part[k0 + tid] = cs;
    }
    acc_tile<DP>(o, s_p, s_k + TF, tr, tc);
    __syncthreads();
    fetch(i + kStages);
  }

  float* ob = a.out + ((size_t)b * Sq + q0) * hd + (size_t)h * D;
#pragma unroll
  for (int r = 0; r < kRM; ++r) {
    if (tr + kRS * r >= rows) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = tc * NC + c;
      if (col < D) ob[(size_t)(tr + kRS * r) * hd + col] = o[r][c];
    }
  }
}

template <int DP>
cudaError_t launch_fwd_f32_dp(const FwdArgs& a, int B, cudaStream_t st) {
  const dim3 grid(n_tiles(a.Sq), a.H, B);
  return launch(attention_fwd_f32<DP>, grid, kThreads, fwd_smem<DP>(), st, a);
}

cudaError_t launch_fwd_f32(FwdArgs a, uint8_t* cls, int B, cudaStream_t st) {
  if (a.mask != nullptr) {
    if (cls == nullptr) return cudaErrorInvalidValue;
    const cudaError_t err =
        launch_tile_classes(a.mask, cls, a.mask_bs != 0 ? B : 1, a.Sq, a.Sk, st);
    if (err != cudaSuccess) return err;
    a.cls = cls;
  } else {
    a.cls = nullptr;
  }
  switch (pad16(a.D)) {
    case 16: return launch_fwd_f32_dp<16>(a, B, st);
    case 32: return launch_fwd_f32_dp<32>(a, B, st);
    case 48: return launch_fwd_f32_dp<48>(a, B, st);
    case 64: return launch_fwd_f32_dp<64>(a, B, st);
    case 80: return launch_fwd_f32_dp<80>(a, B, st);
    case 96: return launch_fwd_f32_dp<96>(a, B, st);
    case 112: return launch_fwd_f32_dp<112>(a, B, st);
    case 128: return launch_fwd_f32_dp<128>(a, B, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace f32
}  // namespace merlot
