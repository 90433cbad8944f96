// The two attention probes' kernels, for Hopper (sm_90a): kernel #10 (the
// pairing probe's bounded attention forward and backward) and kernel #11 (the
// roofline probe's attention products with no softmax).
//
// Both work on (B, S, H*D) bf16 tensors, contiguous, with heads as D-wide
// column slices (D = 64), and take q, k, v and the output cotangent do as four
// pointers; the probes pass one tensor x for all four, as the TPU probes do.
//
// vpt_attention_pairing_probe (kernel #10) replaces
// tools/bench/attention_pairing_probe.py::run_variant (its pallas_call over
// _base_kernel). Per (batch, head), no mask:
//
//   s     = q k^T (fp32);  e = exp2(clip(s * scale * log2e, +-60 * log2e))
//   denom = max(sum_j e, 2^-100);  p = e / denom
//   o     = bf16(e) v / denom;  dv = bf16(p)^T do
//   dp    = do v^T;  delta = sum_j p * dp;  ds = bf16(p * (dp - delta))
//   dq    = ds k * scale;  dk = ds^T q * scale
//   out1  = bf16(o + dv),  out2 = bf16(dq + dk)   (each sum in fp32)
//
// Bound at the probe's shape (B 64, S 304, H 12, D 64), on an H100 SXM: six
// products of 2*B*H*S^2*D = 9.08 GFLOP, 54.5 GFLOP -> 0.0551 ms at 989
// TFLOP/s; bytes x read once and two outputs written, 3 * 29.9 MB = 89.6 MB
// -> 0.0268 ms at 3.35 TB/s: bound by operations, 0.0551 ms.
//
// vpt_attention_dots_probe (kernel #11) replaces
// tools/bench/attention_roofline.py::dots_variant (its pallas_call over
// _dots_only_kernel). Per (batch, head), the products of attention's forward
// and backward with no softmax, scale or mask:
//
//   s  = q k^T (fp32, twice on the TPU: forward and recompute)
//   o  = bf16(s) v;  dv = bf16(s)^T do
//   dp = do v^T;     dq = bf16(dp) k;  dk = bf16(dp)^T q
//   out = bf16((o + dq) + (dv + dk))   (each sum in fp32, accumulated in the
//                                       products' accumulators)
//
// The function needs six products (s is one product, which the TPU probe
// computes twice: its seven dots). Bound at the probe's shape: 6 * 9.08 =
// 54.5 GFLOP -> 0.0551 ms; bytes x read once and one output written, 59.8 MB
// -> 0.0178 ms: bound by operations, 0.0551 ms. The bounds count the products
// as the probes define them over q, k, v and do; that the probes pass one
// tensor for all four is their input, not a property a kernel may use, and
// no product is reassociated ((q k^T) v is not q (k^T v)): the probes time
// attention's (S, S, D) products.
//
// The TPU probes also time a head-PAIRED schedule (_paired_kernel,
// _dots_only_paired_kernel) of the same functions: two 64-wide heads side by
// side, with block-diagonal keys and values, so that the depth-64 products
// fill the TPU's 128-deep matrix unit. It is not ported: wgmma takes a depth
// of 16 a step, so a depth of 64 is four full steps with no idle depth to
// fill, and the block-diagonal operands would double the multiply-adds of 4
// of the 6 products (those that contract over keys or over queries).
//
// Design: every product a wgmma with fp32 accumulators, one warpgroup (128
// threads) a block, one block per (64 rows, head, batch), the tiles 128-byte
// swizzled so that one copy is read K-major and MN-major (hopper.cuh). Blocks
// may not add into one sum (no fp32 atomics: repeated calls give the same
// bits), so a block computes whole rows of each output. Its 64 rows are query
// rows (o, dq contract over keys) and, since the probes' q and k have the same
// number of rows, key rows (dv, dk contract over queries). It sweeps twice
// (probe_kernel): phase A over the key tiles with its own Q and dO rows in
// shared memory, s = Q K^T, dp = dO V^T, then o and dq (#11: o + dq) from the
// weights in registers as the A operand; phase B over the query tiles with its
// own K and V rows, s^T = K Q^T, dp^T = V dO^T, then dv and dk, added to the
// same accumulators; each output is rounded to bf16 once at the end. The
// streamed tiles come by TMA into a ring of kStages slots, the next in flight
// during the products of this one; the own K and V rows take the place of Q and
// dO by TMA during phase A's last step (50 KB a block, four an SM for #11).
// #10's phase B needs 1 / denom and delta of every query, which no block has
// before its own phase A ends, so a first launch (kSums) sweeps the keys of
// each 64 query rows for the row sums of e and e * dp (the bounded softmax has
// no running max, so one sweep gives both) and writes them to `stats`. Products
// executed: #10 10 (s and dp three times: sums, phase A, phase B; then o, dq,
// dv, dk), #11 8, against the functions' 6. Each weight is one SFU exp2
// (fast_exp2) of a clipped logit. Rows past S are loaded as zeros; #10 masks
// the key columns past S out of its sums and gives the queries past S zero
// weights.
// Slower on an H100 (PERF.md): a row launch and a column launch meeting in
// fp32 scratch (with 3-slot rings or 32-row tiles, slower still); this
// design with the own K and V in 16 KB of their own (66 KB a block, three an
// SM); and s and dp as two groups of products, the weights of s formed while
// dp's run (#11 2% faster, but #10 needs 188 registers, two blocks an SM, or
// spills when held to three).
//
// These are the probes' own kernels over hopper.cuh and attention_bwd.cuh's
// two_products, not template flags on the backward pair that #2/#4/#6/#8
// share: that pair takes its weights from the forward's lse, has no o
// product, and splits rows and columns into two launches (its q and k have
// rows of their own); the probes would add a sweep for the sums, an o
// accumulator, phases over both axes in one block and a mode with no
// softmax, each a branch in the kernels of the training path.

#include "attention_bwd.cuh"

using namespace vpt;

namespace {

using bf16 = __nv_bfloat16;

constexpr int kD = 64;                 // head dim
constexpr int kRows = 64;              // rows of a block, and of a tile
constexpr int kThreads = 128;          // one warpgroup
constexpr int kTile = kRows * kD * 2;  // bytes of one swizzled tile
constexpr int kStages = 2;             // slots of the ring of streamed tiles

// what a launch of probe_kernel computes
constexpr int kSums = 0;     // #10's row statistics: 1 / denom and delta
constexpr int kPairing = 1;  // #10's outputs, from the statistics
constexpr int kDots = 2;     // #11's output

struct ProbeParams {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* dout;
  bf16* out1;    // #10: o + dv;  #11: o + dq + dv + dk
  bf16* out2;    // #10: dq + dk; #11: unused
  float* stats;  // #10: (2, B, H, S) 1 / denominator, delta
  int heads, seq;
  float scale, scale_log2;
  // maps (head_tensor_map) over k, v (tiles of keys) and q, dout (tiles of
  // queries), boxes of one 64-row tile
  CUtensorMap k_map, v_map, q_map, do_map;
};

// shared memory of a launch: the block's own rows of Q and dO (phase B:
// of K and V, in the same place); the ring of streamed tiles, of #10's
// statistics of their rows, and its mbarriers; the own rows' mbarrier;
// slack to align the tiles to 1024 bytes
template <int Kind>
constexpr size_t probe_smem() {
  return 1024 + 2 * kTile + kStages * 2 * kTile +
         (Kind == kPairing ? kStages * 2 * kRows * sizeof(float) : 0) +
         (kStages + 1) * sizeof(uint64_t);
}

// e = 2^clip(s * scale * log2e) of a score, by the SFU
__device__ __forceinline__ float weight(float s, float scale_log2) {
  const float lim = kClip * kLog2e;
  return fast_exp2(fminf(fmaxf(s * scale_log2, -lim), lim));
}

// acc (+)= T(a) X and acc2 (+)= T(b) Y over 64 keys or queries: a, b are
// m64n64 accumulators rounded to bf16 as A operands; X, Y 64-row tiles read
// MN-major. #11 passes one accumulator twice.
__device__ __forceinline__ void two_rs_products(float (&acc)[kD / 2],
                                                float (&acc2)[kD / 2],
                                                const float (&a)[kRows / 2],
                                                const float (&b)[kRows / 2],
                                                const unsigned char* x,
                                                const unsigned char* y) {
  uint32_t fa[kRows / 16][4], fb[kRows / 16][4];
#pragma unroll
  for (int kc = 0; kc < kRows / 16; ++kc) {
    pack_a<bf16>(fa[kc], a, kc);
    pack_a<bf16>(fb[kc], b, kc);
  }
  pin(fa);
  pin(fb);
  pin(acc);
  pin(acc2);
  wgmma_fence();
#pragma unroll
  for (int kc = 0; kc < kRows / 16; ++kc)
    wgmma_rs(acc, fa[kc], desc_mnmajor<kRows>(x, kc), 1, (bf16*)nullptr);
#pragma unroll
  for (int kc = 0; kc < kRows / 16; ++kc)
    wgmma_rs(acc2, fb[kc], desc_mnmajor<kRows>(y, kc), 1, (bf16*)nullptr);
  wgmma_commit();
  wgmma_wait<0>();
  pin(acc);
  pin(acc2);
}

// One block per (64 rows, head, batch), rows r0 = 64 * blockIdx.x on: the
// block's query rows and, since q and k have the same number of rows, its
// key rows. Step j streams tile j of a sweep into slot j % kStages:
//   phase A, steps j < ntiles: key tile j (K, V), against the own rows' Q
//     and dO: s = Q K^T, dp = dO V^T; kSums sums e and e * dp over the
//     keys and stops there; kPairing adds o += T(e) V and dq += T(ds) K,
//     kDots acc += T(s) V + T(dp) K;
//   phase B, steps ntiles + i: query tile i (Q, dO; for kPairing with its
//     1 / denom and delta), against the own rows' K and V: s^T = K Q^T,
//     dp^T = V dO^T; kPairing adds dv += T(p^T) dO and dk += T(ds^T) Q to
//     o / denom and dq, kDots acc += T(s^T) dO + T(dp^T) Q.
// Both phases run one body: two products from shared memory into s and dp,
// the weights in registers, then two products with the weights as the A
// operand and the streamed tile read MN-major.
template <int Kind>
__global__ void __launch_bounds__(kThreads)
    probe_kernel(const __grid_constant__ ProbeParams p) {
  constexpr bool Sums = Kind == kSums, Pairing = Kind == kPairing;
  constexpr int STAGES = kStages;
  extern __shared__ __align__(1024) unsigned char smem_probe[];
  // the block's own rows: Q and dO in phase A, K and V in phase B
  unsigned char* own1 = aligned_smem(smem_probe);
  unsigned char* own2 = own1 + kTile;
  unsigned char* ring = own2 + kTile;  // [STAGES][K, V or Q, dO]
  // kPairing: [STAGES][1 / denom, delta][kRows] of phase B's query tiles
  float* rows_ring = reinterpret_cast<float*>(ring + STAGES * 2 * kTile);
  uint64_t* full = reinterpret_cast<uint64_t*>(
      rows_ring + (Pairing ? STAGES * 2 * kRows : 0));
  uint64_t* own_bar = full + STAGES;  // phase B's own K and V

  const int r0 = blockIdx.x * kRows, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int ntiles = (p.seq + kRows - 1) / kRows;
  const int steps = Sums ? ntiles : 2 * ntiles;
  const long long ss = (long long)p.heads * kD;
  const long long off = b * p.seq * ss + h * kD;
  const long long st = ((long long)b * p.heads + h) * p.seq;
  const long long plane = (long long)gridDim.z * p.heads * p.seq;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i <= STAGES; ++i) mbar_init(&full[i], 1);
    mbar_fence_init();
  }
  cp_async_tile<kRows, kD>(own1, p.q + off, ss, r0, p.seq, kThreads);
  cp_async_tile<kRows, kD>(own2, p.dout + off, ss, r0, p.seq, kThreads);
  cp_async_commit();
  __syncthreads();  // the mbarriers are initialised
  // step j's tile into its slot by TMA, one thread, counted on full[slot];
  // kPairing's statistics of a query tile by cp.async, every thread, one
  // group a step (empty where there are none; zeros past S, so that the
  // weights of those queries are 0)
  auto issue = [&](int j) {
    const int slot = j % STAGES;
    const bool second = j >= ntiles;
    const int row0 = (second ? j - ntiles : j) * kRows;
    if (threadIdx.x == 0 && j < steps) {
      unsigned char* tiles = ring + slot * 2 * kTile;
      uint64_t* bar = &full[slot];
      mbar_expect_tx(bar, 2 * kTile);
      tma_load_4d(tiles, second ? &p.q_map : &p.k_map, 0, row0, h, b, bar);
      tma_load_4d(tiles + kTile, second ? &p.do_map : &p.v_map, 0, row0, h,
                  b, bar);
    }
    if constexpr (Pairing) {
      if (second && j < steps) {
        float* rows = rows_ring + slot * 2 * kRows;
        for (int r = threadIdx.x; r < 2 * kRows; r += kThreads) {
          const int row = row0 + (r % kRows);
          const bool ok = row < p.seq;
          const float* src = p.stats + (r < kRows ? 0 : plane) + st;
          cp_async4(rows + r, ok ? src + row : src, ok);
        }
      }
      cp_async_commit();
    }
  };
#pragma unroll
  for (int j = 0; j < STAGES - 1; ++j) issue(j);

  const int rr[2] = {warp * 16 + g, warp * 16 + g + 8};
  // kSums: this thread's partial sums of e and e * dp over the keys, then
  // the rows'; kPairing: the own rows' 1 / denom and delta
  float inv[2] = {0.f, 0.f}, delta[2] = {0.f, 0.f};
  if constexpr (Pairing) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + rr[r];
      if (row < p.seq) {
        inv[r] = p.stats[st + row];
        delta[r] = p.stats[plane + st + row];
      }
    }
  }
  // kPairing: o, then o / denom + dv; dq, then dq + dk (before the scale).
  // kDots: o + dq + dv + dk in acc1.
  float acc1[kD / 2], acc2[kD / 2];
#pragma unroll
  for (int i = 0; i < kD / 2; ++i) acc1[i] = acc2[i] = 0.f;

  for (int j = 0; j < steps; ++j) {
    // the own rows (and kPairing's statistics of step j) have landed
    cp_async_wait<Pairing ? STAGES - 2 : 0>();
    fence_async_smem();
    __syncthreads();  // ... for every thread; slot j - 1 is free
    issue(j + STAGES - 1);
    const int slot = j % STAGES;
    mbar_wait(&full[slot], (j / STAGES) & 1);  // step j's tile
    const bool second = j >= ntiles;
    const int row0 = (second ? j - ntiles : j) * kRows;
    const unsigned char* x = ring + slot * 2 * kTile;  // K or Q
    const unsigned char* y = x + kTile;                // V or dO

    if (!Sums && j == ntiles) mbar_wait(own_bar, 0);  // own K and V
    float s[kRows / 2], dp[kRows / 2];  // phase B: s^T, dp^T
    two_products<bf16, kD, kRows>(s, dp, own1, x, own2, y);
    if (!Sums && j == ntiles - 1) {
      // Q and dO are read for the last time: the own rows' K and V take
      // their place by TMA while this step's other products run
      __syncthreads();
      if (threadIdx.x == 0) {
        mbar_expect_tx(own_bar, 2 * kTile);
        tma_load_4d(own1, &p.k_map, 0, r0, h, b, own_bar);
        tma_load_4d(own2, &p.v_map, 0, r0, h, b, own_bar);
      }
    }

    if constexpr (Sums) {
#pragma unroll
      for (int i = 0; i < kRows / 2; ++i) {
        const int r = (i >> 1) & 1;
        const int key = row0 + (i >> 2) * 8 + 2 * t + (i & 1);
        const float e = key < p.seq ? weight(s[i], p.scale_log2) : 0.f;
        inv[r] += e;
        delta[r] = fmaf(e, dp[i], delta[r]);
      }
      continue;
    }
    if constexpr (Pairing) {
      if (!second) {  // e and ds of the own query rows
#pragma unroll
        for (int i = 0; i < kRows / 2; ++i) {
          const int r = (i >> 1) & 1;
          const int key = row0 + (i >> 2) * 8 + 2 * t + (i & 1);
          const float e = key < p.seq ? weight(s[i], p.scale_log2) : 0.f;
          s[i] = e;
          dp[i] = e * inv[r] * (dp[i] - delta[r]);
        }
      } else {  // p^T and ds^T of the own key rows
        if (j == ntiles) {  // o is done: o / denom
#pragma unroll
          for (int i = 0; i < kD / 2; ++i) acc1[i] *= inv[(i >> 1) & 1];
        }
        const float* inv_s = rows_ring + slot * 2 * kRows;
        const float* delta_s = inv_s + kRows;
#pragma unroll
        for (int n = 0; n < kRows / 8; ++n) {
          const int qi = n * 8 + 2 * t;  // this thread's two query columns
          const float2 iv = *reinterpret_cast<const float2*>(inv_s + qi);
          const float2 dl = *reinterpret_cast<const float2*>(delta_s + qi);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = 4 * n + e;
            const float pr =
                weight(s[i], p.scale_log2) * ((e & 1) ? iv.y : iv.x);
            s[i] = pr;
            dp[i] = pr * (dp[i] - ((e & 1) ? dl.y : dl.x));
          }
        }
      }
      // phase A: o += T(e) V, dq += T(ds) K;
      // phase B: dv += T(p^T) dO, dk += T(ds^T) Q
      two_rs_products(acc1, acc2, s, dp, y, x);
    } else {
      // phase A: acc += T(s) V + T(dp) K; B: acc += T(s^T) dO + T(dp^T) Q
      two_rs_products(acc1, acc1, s, dp, y, x);
    }
  }
  if constexpr (Pairing) cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + rr[r];
    if constexpr (Sums) {  // the whole rows' sums
      const float denom = fmaxf(row_sum<4>(inv[r]), kDenomFloor);
      const float d = row_sum<4>(delta[r]) / denom;
      if (t == 0 && row < p.seq) {
        p.stats[st + row] = 1.f / denom;
        p.stats[plane + st + row] = d;
      }
      continue;
    }
    if (row >= p.seq) continue;
    const long long at = off + row * ss + 2 * t;
#pragma unroll
    for (int n = 0; n < kD / 8; ++n) {
      *reinterpret_cast<uint32_t*>(p.out1 + at + n * 8) =
          pack_bf16(acc1[4 * n + 2 * r], acc1[4 * n + 2 * r + 1]);
      if constexpr (Pairing)
        *reinterpret_cast<uint32_t*>(p.out2 + at + n * 8) =
            pack_bf16(acc2[4 * n + 2 * r] * p.scale,
                      acc2[4 * n + 2 * r + 1] * p.scale);
    }
  }
}

// the tensor maps over q, k, v and dout, then (#10) the statistics launch
// and the output launch on `stream`
int launch_probe(ProbeParams p, bool pairing, int batch, cudaStream_t stream) {
  if (const cudaError_t err = bind_current_device()) return (int)err;
  const long long ss = (long long)p.heads * kD, sb = p.seq * ss;
  const struct {
    CUtensorMap* map;
    const void* base;
  } maps[4] = {{&p.k_map, p.k}, {&p.v_map, p.v}, {&p.q_map, p.q},
               {&p.do_map, p.dout}};
  for (const auto& m : maps)
    if (int rc = head_tensor_map<bf16>(m.map, m.base, kD, p.seq, p.heads,
                                       batch, sb, ss, kD, kRows))
      return rc;
  const dim3 grid((p.seq + kRows - 1) / kRows, p.heads, batch);
  if (!pairing)
    return launch(probe_kernel<kDots>, p, grid, kThreads, probe_smem<kDots>(),
                  stream);
  int rc = launch(probe_kernel<kSums>, p, grid, kThreads, probe_smem<kSums>(),
                  stream);
  if (rc != 0) return rc;
  return launch(probe_kernel<kPairing>, p, grid, kThreads,
                probe_smem<kPairing>(), stream);
}

ProbeParams params(const void* q, const void* k, const void* v,
                   const void* dout, int heads, int seq) {
  ProbeParams p{};
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.dout = static_cast<const bf16*>(dout);
  p.heads = heads;
  p.seq = seq;
  p.scale = 1.f;
  p.scale_log2 = kLog2e;
  return p;
}

}  // namespace

// q, k, v, dout, out1, out2: contiguous (B, S, H*64) bf16; stats: 2 * B * H
// * S fp32 scratch. Two launches on `stream`. Returns 0, a cudaError_t or
// CUresult code, or -1 for a head_dim other than 64.
extern "C" int vpt_attention_pairing_probe(
    const void* q, const void* k, const void* v, const void* dout, void* out1,
    void* out2, float* stats, int batch, int seq, int heads, int head_dim,
    float scale, void* stream) {
  if (head_dim != kD) return -1;
  ProbeParams p = params(q, k, v, dout, heads, seq);
  p.out1 = static_cast<bf16*>(out1);
  p.out2 = static_cast<bf16*>(out2);
  p.stats = stats;
  p.scale = scale;
  p.scale_log2 = scale * kLog2e;
  return launch_probe(p, true, batch, static_cast<cudaStream_t>(stream));
}

// q, k, v, dout, out: contiguous (B, S, H*64) bf16. One launch on `stream`.
// Returns 0, a cudaError_t or CUresult code, or -1 for a head_dim other than
// 64.
extern "C" int vpt_attention_dots_probe(const void* q, const void* k,
                                        const void* v, const void* dout,
                                        void* out, int batch, int seq,
                                        int heads, int head_dim, void* stream) {
  if (head_dim != kD) return -1;
  ProbeParams p = params(q, k, v, dout, heads, seq);
  p.out1 = static_cast<bf16*>(out);
  return launch_probe(p, false, batch, static_cast<cudaStream_t>(stream));
}
