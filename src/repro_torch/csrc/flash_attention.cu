// Blockwise online-softmax attention with grouped KV heads (flash
// attention), for Hopper (sm_90a).
//
// Replaces the Pallas kernel src/repro/kernels/flash_attention/kernel.py
// (_flash_kernel / flash_attention, the pallas_call at line 116).  It
// computes the same function: out = softmax(mask(softcap(q k^T * scale))) v
// per query head h over KV head h / (H / K), with end-aligned causal
// masking (key j is visible to query i iff j <= i + T - S), masked logits
// set to -2**30, the row max, the row sum and the accumulator in f32, the
// final row sum clamped at 1e-20, and the output cast to the input type.
//
// It adds a sliding window, which the Pallas kernel lacks (the JAX model
// computes it in its jnp attend): with window > 0 (causal only), key j is
// visible to query i only if also i + T - S - j < window
// (q_pos - k_pos < window).
//
// Unlike the Pallas kernel it takes any S and T (decode has T = pos + 1,
// which no tile size divides), masking the ragged last key tile, and it
// reads q (B, S, H, d) and k, v (B, T, K, d) in the model's layout through
// their strides, so a cache prefix k_cache[:, :pos+1] goes in without a
// copy.  The output is contiguous (B, S, H, d).  Head dims 32, 64, 128 and
// 256 (gemma2's).
//
// The diagonal is an argument, diag: query i sees key j iff j <= i + diag
// (and i + diag - j < window).  The wrapper passes T - S unless asked
// otherwise, so the end-aligned calls above are diag's default.  A slice
// of a KV cache cut over T (keys at absolute positions lo..lo+T-1, queries
// at offset..offset+S-1) takes diag = offset - lo; its queries may then see
// none of its keys.  A row that sees no key (its range [max(0, i + diag -
// window + 1), min(T - 1, i + diag)] empty) writes zeros and lse = -inf on
// every route, so that partials merged by the log-sum-exp rule weigh it 0.
// Routes B and C are compiled twice, for the end-aligned diagonal (GENERAL
// false: the code before the argument existed, constant-folded, so the
// default calls keep their speed) and for any other (GENERAL true).
//
// Three routes; the wrapper (kernels/flash_attention/kernel.py) picks one
// and plans the split of route B:
//
// A. flash_fwd_wgmma: bf16 with more than 16 rows (query, head of the
//    group) per (batch, KV head): prefill.  Bound by operations (4 B H d
//    times the visible pairs, on the bf16 tensor cores).  Both products run
//    as wgmma with f32 accumulators: S = Q K^T with Q and K in shared
//    memory, O += P V with P in registers (the S accumulator rounded to
//    bf16 in place, never through shared memory) and V read transposed
//    from shared memory.  P goes in as two bf16 parts, hi = bf16(p) and
//    lo = bf16(p - hi), one product each: the Pallas kernel casts p to v's
//    type, but a bf16 weight is off by up to 2**-9 of itself, which at a
//    short prefix reaches the output undiluted (0.0087 against f32
//    probabilities at S = T = 300, PERF.md); hi + lo keeps ~16 bits.  Q, K
//    and V arrive by TMA into 64- or 128-byte-swizzled tiles, the layout
//    the wgmma descriptors name; 4-D tensor maps over the strided views
//    zero-fill past T, and the key mask covers the ragged last tile.  One
//    CTA per (query tile of 128 rows, query head, batch): two consumer
//    warpgroups of 64 rows and one producer warp, which keeps a ring of
//    three K/V stages in flight, each guarded by a full and an empty
//    mbarrier.  Query tiles are launched longest first; key tiles above
//    the tile's causal diagonal or below its window are never loaded, and
//    a warpgroup skips those wholly outside its own 64 rows (it still takes
//    part in the ring).  Tiles of BN = 64 keys, 128 at d = 32.  At d = 256
//    the O accumulator alone is 64 x 256 f32 over a warpgroup's 128 threads,
//    128 registers a thread, where a 288-thread CTA gets 168: that instance
//    has one consumer warpgroup beside the producer warp (160 threads, up
//    to 255 registers), 32-key tiles and a two-stage ring (the table below),
//    and runs O += P V as two products of 128 columns.
// B. flash_fwd_split: bf16 with at most 16 rows per (batch, KV head):
//    decode.  Bound by the bytes of the visible K/V.  The visible key range
//    is cut into n_splits chunks of at least 128 keys (planned by the
//    wrapper: about four blocks an SM at d = 64, two at d = 128, one at
//    d = 256); one block of
//    four warps per (chunk, batch, KV head) streams its chunk through a
//    three-stage cp.async ring of 32-key tiles.  The G rows of the KV head
//    (padded to 16) meet each tile in two mma.sync products (m16n8k16,
//    bf16 in, f32 accumulators): Q K^T with Q held in registers, then P V
//    with P through shared memory in two bf16 parts, as in route A.  (Run on
//    the f32 CUDA cores instead, the block was bound by its own
//    instructions, not by the bytes: PERF.md.)  It writes a partial
//    (m, l, acc) in f32; the last block of each (batch, KV head) to finish
//    (a threadfence and an atomic ticket, which it resets) merges the
//    partials by the log-sum-exp rule into the output.  A partial whose row
//    saw no visible key has m = -2**30 and merges with weight
//    exp(-2**30 - m) = 0; the plan makes no split without a visible key,
//    but where no row sees a key at all (a cache slice wholly after the
//    queries) it makes one, whose rows all write zeros.
// C. flash_fwd: f32 calls, the first version's kernel, now for f32 only: f32
//    products on the CUDA cores, so f32 agrees with the plain version to
//    rounding.  One block of 256 threads per (batch, KV head, tile of BM
//    rows), a row being one (query, head of the KV head's group) pair, so the
//    G query heads that share a KV head share each K/V tile staged in shared
//    memory.  The threads form a 16 x 16 grid; thread (ty, tx) owns rows ty +
//    16 i, score columns tx + 16 j and output columns [D/16 tx, D/16 (tx +
//    1)), so a row's 16 owners sit in one half-warp and reduce its max and
//    sum with shuffles.  Per 64-key tile, K and V are staged in shared memory
//    as f32 with 16-byte loads, all issued before the first store; the
//    probabilities go through shared memory, over the K tile, for the P V
//    product.  Key tiles wholly above the block's last visible key, or wholly
//    below its first row's first visible key, are never loaded (at d = 256
//    BM is 32, so the accumulators stay as many a thread as at d = 128, and
//    a block of 166,400 B of shared memory takes an SM alone: its instance
//    may use 255 registers).  A later row
//    of the block may find a loaded tile wholly outside its window: its
//    probabilities there come out as exp(NEG - NEG) = 1, and the first tile
//    that holds one of its visible keys scales them by exp(NEG - m) = 0
//    (routes A and B keep the same convention).  BM is 64, or 16 when the
//    block holds at most 16 rows.
//
// Every route takes a nullable f32 pointer lse, laid out (B, H, S).  When it
// is not null (the training path's forward, whose backward needs it), each
// route writes every (query, head) row's log-sum-exp m + log(max(l, 1e-20))
// from the same f32 row max m and row sum l that normalise the output
// (route A keeps m in log2 units and converts; route B's split calls write
// it where the partials merge), so the backward never recomputes Q K^T for
// it.  A null pointer leaves the instructions that write the output as
// they were: the serving path's outputs are the same bytes.
//
// Every row must start on a 16-byte boundary.
//
// Each bf16 instance, from ptxas (nvcc 12.9, -O3, sm_90a; chip_smoke.py
// logs the report of a fresh build) and the shared-memory formulas below.
// None spills (route C's f32 d = 128, BM = 64 instance spills 92 bytes, as
// it did before routes A and B):
//
//   instance               registers  dynamic smem  blocks an SM
//   flash_fwd_wgmma<256>   205         99,328 B     1 (160 threads each)
//   flash_fwd_wgmma<128>   168        132,096 B     1 (288 threads each)
//   flash_fwd_wgmma<64>    161         66,560 B     1
//   flash_fwd_wgmma<32>    168         58,368 B     1
//   flash_fwd_split<256>   167        104,192 B     2 (128 threads each)
//   flash_fwd_split<128>   102         55,040 B     4 (128 threads each)
//   flash_fwd_split<64>     64         30,464 B     7
//   flash_fwd_split<32>     56         18,176 B     9
//
// (the split rows are the end-aligned instances; chip_smoke.py logs the
// general-diagonal ones beside them, ``general_diag`` in its instance lines;
// route C's f32 d = 256 instances, BM = 32 and 16, take 244 and 215)
//
// flash_fwd_wgmma<256> has a configuration of its own (Cfg below).  The
// d = 128 one's, 3 stages of 64-key K and V tiles beside two warpgroups'
// Q, comes to 263,168 B, over the 232,448 a block may have, and its O
// accumulator would take 128 of the 168 registers a 288-thread CTA
// allows, so S, P and the addresses would spill.  Chosen: one consumer
// warpgroup (a 160-thread CTA, which ptxas may give 255 registers a
// thread), so nothing spills and no setmaxnreg is needed; 32-key tiles and
// two stages, 99,328 B, room for two CTAs an SM, whose warpgroups would
// overlap one's softmax with the other's products; but ptxas takes 205
// registers, over the 200 two 160-thread CTAs may each have, so one runs
// an SM (__launch_bounds__(160, 2) would ask for 200).  setmaxnreg
// (FlashAttention-3's producer warpgroup at ~40 registers, two consumer
// warpgroups at ~232) is the faster design, left to a later change.

#include "hopper.cuh"

namespace {

constexpr float NEG = -1073741824.0f;  // -2**30, the Pallas kernel's mask value
constexpr int BN = 64;                 // keys per tile
constexpr int THREADS = 256;           // a 16 x 16 grid of threads

// A ROWS x D tile moves to shared memory in two steps, so that the loads
// of several tiles are all in flight before the first store: tile_load
// issues this thread's 16-byte loads (row_ptr(r) is row r's first element,
// or null for a row past the edge, staged as zeros), tile_store writes them
// to shared memory with row stride ld.
template <int ROWS, int D>
struct Tile {
  static constexpr int PER_ROW = D / 4;
  static constexpr int CHUNKS = ROWS * PER_ROW;
  static constexpr int PER_THREAD = (CHUNKS + THREADS - 1) / THREADS;
  float4 buf[PER_THREAD];

  template <typename RowPtr>
  __device__ __forceinline__ void load(RowPtr row_ptr) {
#pragma unroll
    for (int n = 0; n < PER_THREAD; ++n) {
      const int u = threadIdx.x + n * THREADS;
      buf[n] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (u < CHUNKS) {
        const float* p = row_ptr(u / PER_ROW);
        if (p != nullptr) buf[n] = __ldg(reinterpret_cast<const float4*>(p + (u % PER_ROW) * 4));
      }
    }
  }

  __device__ __forceinline__ void store(float* dst, int ld) const {
#pragma unroll
    for (int n = 0; n < PER_THREAD; ++n) {
      const int u = threadIdx.x + n * THREADS;
      if (u < CHUNKS)
        *reinterpret_cast<float4*>(dst + (u / PER_ROW) * ld + (u % PER_ROW) * 4) = buf[n];
    }
  }
};

__device__ __forceinline__ float lane(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

struct Strides {
  long long b, s, h;  // elements; the head dim is contiguous
};

// Does query row s see any key of T under the diagonal and window?
__device__ __forceinline__ bool row_sees(long long s, int T_len, int diag, int causal,
                                         int window) {
  const long long hi = causal ? min((long long)T_len - 1, s + diag) : T_len - 1;
  const long long lo = window > 0 ? max(0LL, s + diag - window + 1) : 0;
  return hi >= lo;
}

// Shared memory, in floats: Q [BM][D+4], then K [BN][D+4] with room for
// P [BM][BN+4] over it once the scores are done, then V [BN][D+4].
template <int D, int BM>
__host__ __device__ constexpr int k_floats() {
  return BN * (D + 4) > BM * (BN + 4) ? BN * (D + 4) : BM * (BN + 4);
}
template <int D, int BM>
__host__ __device__ constexpr int smem_floats() {
  return BM * (D + 4) + k_floats<D, BM>() + BN * (D + 4);
}

template <int D, int BM, bool GENERAL>
__global__ void __launch_bounds__(THREADS, D == 256 ? 1 : 2)
    flash_fwd(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
              int S, int T_len, int H, int KH, Strides qs, Strides ks, Strides vs, float scale,
              float softcap, int causal, int window, int diag) {
  constexpr int RM = BM / 16;  // rows per thread
  constexpr int CN = BN / 16;  // score columns per thread
  constexpr int CD = D / 16;   // output columns per thread (contiguous)
  constexpr int LDQ = D + 4;   // padded row strides, 16-byte aligned
  constexpr int LDP = BN + 4;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // [BM][LDQ]
  float* Ks = Qs + BM * LDQ;                    // [BN][LDQ]
  float* Ps = Ks;                               // [BM][LDP], over K once the scores are done
  float* Vs = Ks + k_floats<D, BM>();           // [BN][LDQ]

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int G = H / KH;
  const int b = blockIdx.y / KH, kh = blockIdx.y % KH;
  const long long rows = (long long)S * G;
  const long long r0 = (long long)blockIdx.x * BM;
  // Stage the block's query rows; row r is query s = R / G of head kh G + R % G.
  {
    Tile<BM, D> qt;
    qt.load([&](int r) -> const float* {
      const long long R = r0 + r;
      if (R >= rows) return nullptr;
      return q + b * qs.b + (R / G) * qs.s + ((long long)kh * G + R % G) * qs.h;
    });
    qt.store(Qs, LDQ);
  }

  // The last key each of this thread's rows may see under the diagonal, lim
  // (causal: s + diag; with a general diagonal it may lie past the last key
  // T - 1, and keys past T are masked on their own, else it never does);
  // with a window the first is lim - window + 1.
  if (!GENERAL) diag = T_len - S;
  int lim[RM];
  float m[RM], l[RM], acc[RM][CD];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const long long R = r0 + ty + 16 * i;
    const long long s = R < rows ? R / G : S - 1;
    lim[i] = !causal ? T_len - 1 : GENERAL ? (int)(s + diag)
                                           : (int)min((long long)T_len - 1, s + diag);
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CD; ++c) acc[i][c] = 0.f;
  }
  // Keys past the block's last visible key, and tiles below its first
  // row's first visible key, are never loaded.
  const long long s_last = min((long long)S - 1, (r0 + BM - 1) / G);
  const int n_keys = causal ? (int)min((long long)T_len, s_last + diag + 1) : T_len;
  const int key0 = window > 0 ? (int)max(0LL, r0 / G + diag - window + 1) : 0;

  for (int t0 = key0 / BN * BN; t0 < n_keys; t0 += BN) {
    __syncthreads();  // the last tile's readers are done
    {
      Tile<BN, D> kt, vt;
      kt.load([&](int j) -> const float* {
        const long long tj = t0 + j;
        return tj < T_len ? k + b * ks.b + tj * ks.s + (long long)kh * ks.h : nullptr;
      });
      vt.load([&](int j) -> const float* {
        const long long tj = t0 + j;
        return tj < T_len ? v + b * vs.b + tj * vs.s + (long long)kh * vs.h : nullptr;
      });
      kt.store(Ks, LDQ);
      vt.store(Vs, LDQ);
    }
    __syncthreads();

    float sc[RM][CN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < D; c += 4) {
      float4 qv[RM], kv[CN];
#pragma unroll
      for (int i = 0; i < RM; ++i)
        qv[i] = *reinterpret_cast<const float4*>(Qs + (ty + 16 * i) * LDQ + c);
#pragma unroll
      for (int j = 0; j < CN; ++j)
        kv[j] = *reinterpret_cast<const float4*>(Ks + (tx + 16 * j) * LDQ + c);
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < CN; ++j) {
          sc[i][j] = fmaf(qv[i].x, kv[j].x, sc[i][j]);
          sc[i][j] = fmaf(qv[i].y, kv[j].y, sc[i][j]);
          sc[i][j] = fmaf(qv[i].z, kv[j].z, sc[i][j]);
          sc[i][j] = fmaf(qv[i].w, kv[j].w, sc[i][j]);
        }
    }
    __syncthreads();  // every thread is done with K: P goes over it

    // Online softmax over this tile, row by row.
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      float mx = NEG;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        float x = sc[i][j] * scale;
        if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
        const int key = t0 + tx + 16 * j;
        if (key > lim[i] || (GENERAL && key >= T_len) || (window > 0 && lim[i] - key >= window))
          x = NEG;
        sc[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int w = 8; w > 0; w >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        const float p = expf(sc[i][j] - m_new);
        Ps[(ty + 16 * i) * LDP + tx + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int w = 8; w > 0; w >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, w);
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + sum;
#pragma unroll
      for (int c = 0; c < CD; ++c) acc[i][c] *= alpha;
      m[i] = m_new;
    }
    __syncthreads();

#pragma unroll 2
    for (int j = 0; j < BN; j += 4) {
      float4 pv[RM];
#pragma unroll
      for (int i = 0; i < RM; ++i)
        pv[i] = *reinterpret_cast<const float4*>(Ps + (ty + 16 * i) * LDP + j);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float* vrow = Vs + (j + jj) * LDQ + CD * tx;
        float vv[CD];
        if constexpr (CD % 4 == 0) {
#pragma unroll
          for (int c = 0; c < CD; c += 4) {
            const float4 w = *reinterpret_cast<const float4*>(vrow + c);
            vv[c] = w.x, vv[c + 1] = w.y, vv[c + 2] = w.z, vv[c + 3] = w.w;
          }
        } else {
#pragma unroll
          for (int c = 0; c < CD; c += 2) {
            const float2 w = *reinterpret_cast<const float2*>(vrow + c);
            vv[c] = w.x, vv[c + 1] = w.y;
          }
        }
#pragma unroll
        for (int i = 0; i < RM; ++i) {
          const float p = lane(pv[i], jj);
#pragma unroll
          for (int c = 0; c < CD; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const long long R = r0 + ty + 16 * i;
    if (R >= rows) continue;
    const long long s = R / G;
    const long long h = (long long)kh * G + R % G;
    const bool sees = !GENERAL || row_sees(s, T_len, diag, causal, window);
    const float den = fmaxf(l[i], 1e-20f);
    float* orow = o + ((long long)b * S + s) * ((long long)H * D) + h * D + CD * tx;
#pragma unroll
    for (int c = 0; c < CD; ++c) orow[c] = sees ? acc[i][c] / den : 0.f;
    if (lse != nullptr && tx == 0)
      lse[((long long)b * H + h) * S + s] = sees ? m[i] + logf(den) : -INFINITY;
  }
}

template <int D, int BM, bool GENERAL>
int launch_diag(const void* q, const void* k, const void* v, void* o, float* lse, int B, int S,
                int T_len, int H, int KH, Strides qs, Strides ks, Strides vs, float scale,
                float softcap, int causal, int window, int diag, cudaStream_t stream) {
  constexpr int smem = smem_floats<D, BM>() * (int)sizeof(float);
  static bool ready = false;  // one attribute call per instance (above 48 KB needs it)
  if (!ready) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd<D, BM, GENERAL>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    ready = true;
  }
  const long long rows = (long long)S * (H / KH);
  const dim3 grid((unsigned)((rows + BM - 1) / BM), (unsigned)(B * KH));
  flash_fwd<D, BM, GENERAL><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), lse, S, T_len, H, KH, qs, ks, vs, scale, softcap, causal, window,
      diag);
  return static_cast<int>(cudaGetLastError());
}

template <int D, int BM>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, int B, int S,
           int T_len, int H, int KH, Strides qs, Strides ks, Strides vs, float scale,
           float softcap, int causal, int window, int diag, cudaStream_t stream) {
  if (diag == T_len - S)
    return launch_diag<D, BM, false>(q, k, v, o, lse, B, S, T_len, H, KH, qs, ks, vs, scale,
                                     softcap, causal, window, diag, stream);
  return launch_diag<D, BM, true>(q, k, v, o, lse, B, S, T_len, H, KH, qs, ks, vs, scale,
                                  softcap, causal, window, diag, stream);
}

// BM: 16 rows for a block that holds at most 16, else 64, or 32 at d = 256
// (a thread's accumulators then number BM / 16 x D / 16 = 32, as at d = 128)
template <int D>
int launch_rows(const void* q, const void* k, const void* v, void* o, float* lse, int B, int S,
                int T_len, int H, int KH, Strides qs, Strides ks, Strides vs, float scale,
                float softcap, int causal, int window, int diag, cudaStream_t stream) {
  if ((long long)S * (H / KH) <= 16)
    return launch<D, 16>(q, k, v, o, lse, B, S, T_len, H, KH, qs, ks, vs, scale, softcap,
                         causal, window, diag, stream);
  constexpr int BM = D == 256 ? 32 : 64;
  return launch<D, BM>(q, k, v, o, lse, B, S, T_len, H, KH, qs, ks, vs, scale, softcap, causal,
                       window, diag, stream);
}

int launch_dim(const void* q, const void* k, const void* v, void* o, float* lse, int B, int S,
               int T_len, int H, int KH, int D, Strides qs, Strides ks, Strides vs, float scale,
               float softcap, int causal, int window, int diag, cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch_rows<32>(q, k, v, o, lse, B, S, T_len, H, KH, qs, ks, vs, scale, softcap,
                             causal, window, diag, stream);
    case 64:
      return launch_rows<64>(q, k, v, o, lse, B, S, T_len, H, KH, qs, ks, vs, scale, softcap,
                             causal, window, diag, stream);
    case 128:
      return launch_rows<128>(q, k, v, o, lse, B, S, T_len, H, KH, qs, ks, vs, scale, softcap,
                              causal, window, diag, stream);
    case 256:
      return launch_rows<256>(q, k, v, o, lse, B, S, T_len, H, KH, qs, ks, vs, scale, softcap,
                              causal, window, diag, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// ------------------------------------------------ helpers of routes A and B
namespace {

// Probabilities (a, b) as two bf16 pairs whose sum keeps ~16 of their bits:
// hi = bf16(x), lo = bf16(x - hi).  P V runs once with each, so P's bf16
// rounding (2**-9 of a weight, which a short prefix does not average away)
// does not reach the output.
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(a - __low2float(h), b - __high2float(h));
}

}  // namespace

// ------------------------------------------------ route A: wgmma prefill
namespace wg {

constexpr int ROWS = 64;  // query rows of a consumer warpgroup

template <int D>
struct Cfg {
  // consumer warpgroups: two, or one at d = 256 (its O accumulator alone is
  // 128 registers a thread: the source's note)
  static constexpr int NWG = D == 256 ? 1 : 2;
  static constexpr int THREADS = (NWG * 4 + 1) * 32;  // and one producer warp
  static constexpr int STAGES = D == 256 ? 2 : 3;     // K/V ring
  // keys per tile: at d = 64, 128 keys spill at the 168 registers ptxas
  // allows 288 threads; at d = 256, 32 keep two CTAs' rings within an SM
  static constexpr int BN = D == 32 ? 128 : D == 256 ? 32 : 64;
  static constexpr int SW = D * 2 < 128 ? D * 2 : 128;  // swizzle span: the bytes of a tile row
  static constexpr int PANELS = D * 2 / SW;     // column panels of SW bytes
  static constexpr int KSTEPS = SW / 32;        // k-steps of 16 elements in a panel
  static constexpr int Q_BYTES = NWG * ROWS * D * 2;
  static constexpr int KV_BYTES = BN * D * 2;   // one K or V tile
  static constexpr int SMEM = Q_BYTES + STAGES * 2 * KV_BYTES + 1024;  // + alignment slack
  static constexpr uint64_t LAYOUT = SW == 128 ? 1 : 2;
};
static_assert(Cfg<256>::SMEM <= 232448 && Cfg<128>::SMEM <= 232448, "a block's shared memory");

struct Params {
  int S, T, H, KH, n_qtiles;
  float scale, softcap;
  int causal, window, diag;
  float* lse;  // (B, H, S) or null
};

template <int D>
__global__ void __launch_bounds__(Cfg<D>::THREADS, 1)
    flash_fwd_wgmma(const __grid_constant__ CUtensorMap qmap,
                    const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap vmap, __nv_bfloat16* __restrict__ o,
                    Params p) {
  using C = Cfg<D>;
  constexpr int BN = C::BN, SW = C::SW, PANELS = C::PANELS, NWG = C::NWG, STAGES = C::STAGES;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * STAGES + 1];  // full[STAGES], empty[STAGES], q
  // swizzled tiles start on 1,024-byte boundaries (the swizzle pattern's period)
  const uint32_t q_s = (smem_u32(smem_raw) + 1023u) & ~1023u;  // [NWG][PANELS][ROWS][SW]
  const uint32_t kv_s = q_s + C::Q_BYTES;  // [STAGES][K, V][PANELS][BN][SW]
  const uint32_t full0 = smem_u32(&bars[0]), empty0 = smem_u32(&bars[STAGES]);
  const uint32_t qbar = smem_u32(&bars[2 * STAGES]);

  const int h = blockIdx.x, b = blockIdx.z;
  const int s0 = (p.n_qtiles - 1 - (int)blockIdx.y) * NWG * ROWS;  // longest tiles first
  const int kh = h / (p.H / p.KH);
  const int off = p.diag;  // query s sees keys up to s + off
  // the keys any row of the tile sees, in whole tiles (none: a tile of keyless rows)
  const int s_last = min(p.S - 1, s0 + NWG * ROWS - 1);
  const int key_end = p.causal ? min(p.T, s_last + off + 1) : p.T;
  const int key_beg = p.window > 0 ? max(0, s0 + off - p.window + 1) : 0;
  const int kt0 = key_beg / BN;
  const int n_tiles = key_end > key_beg ? (key_end + BN - 1) / BN - kt0 : 0;

  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(full0 + 8 * i, 1);
      mbar_init(empty0 + 8 * i, NWG * 4);  // every consumer warp releases the stage
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == NWG * 4) {  // the producer: one thread issues every copy
    if (lane == 0) {
      mbar_expect_tx(qbar, C::Q_BYTES);
      for (int w = 0; w < NWG; ++w)
        for (int pn = 0; pn < PANELS; ++pn)
          tma_load_4d(&qmap, q_s + (w * PANELS + pn) * ROWS * SW, qbar, pn * SW / 2,
                      s0 + w * ROWS, h, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int st = i % STAGES;
        if (i >= STAGES) mbar_wait(empty0 + 8 * st, ((i / STAGES) + 1) & 1);
        const uint32_t ks = kv_s + st * 2 * C::KV_BYTES, vs = ks + C::KV_BYTES;
        mbar_expect_tx(full0 + 8 * st, 2 * C::KV_BYTES);
        const int t0 = (kt0 + i) * BN;
        for (int pn = 0; pn < PANELS; ++pn) {
          tma_load_4d(&kmap, ks + pn * BN * SW, full0 + 8 * st, pn * SW / 2, t0, kh, b);
          tma_load_4d(&vmap, vs + pn * BN * SW, full0 + 8 * st, pn * SW / 2, t0, kh, b);
        }
      }
    }
    return;
  }

  // A consumer warpgroup: 64 query rows.  In the wgmma accumulator layout
  // this thread holds rows r and r + 8 (r = 16 warp + lane / 4), columns
  // 8 j + 2 (lane % 4) + {0, 1} of each 8-column chunk j.
  const int wgi = warp / 4;
  const int wg_s0 = s0 + wgi * ROWS;
  const int row = wg_s0 + 16 * (warp % 4) + lane / 4;
  const int col = 2 * (lane % 4);
  int hi[2], lo[2];  // each row's visible keys: lo <= key <= hi
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int s = row + 8 * r;
    hi[r] = p.causal ? min(p.T - 1, s + off) : p.T - 1;
    lo[r] = p.window > 0 ? s + off - p.window + 1 : 0;
  }
  // the keys some row of this warpgroup sees, and those all of them see
  const int wg_hi = p.causal ? min(p.T - 1, wg_s0 + ROWS - 1 + off) : p.T - 1;
  const int wg_lo = p.window > 0 ? wg_s0 + off - p.window + 1 : 0;
  const int all_hi = p.causal ? min(p.T - 1, wg_s0 + off) : p.T - 1;
  const int all_lo = p.window > 0 ? wg_s0 + ROWS - 1 + off - p.window + 1 : 0;
  const float qk_scale = p.softcap > 0.f ? p.scale / p.softcap : p.scale * LOG2E;
  const float cap_scale = p.softcap * LOG2E;

  float oacc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) oacc[i] = 0.f;
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};  // row max (log2 units) and this thread's row sums

  mbar_wait(qbar, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int st = i % STAGES;
    const int t0 = (kt0 + i) * BN;
    const uint32_t ks = kv_s + st * 2 * C::KV_BYTES, vs = ks + C::KV_BYTES;
    mbar_wait(full0 + 8 * st, (i / STAGES) & 1);
    if (wg_s0 < p.S && t0 <= wg_hi && t0 + BN - 1 >= wg_lo) {
      float sacc[BN / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int pn = kk / C::KSTEPS, w = kk % C::KSTEPS;
        const uint64_t da = gmma_desc(q_s + (wgi * PANELS + pn) * ROWS * SW + w * 32, 16,
                                      8 * SW, C::LAYOUT);
        const uint64_t db = gmma_desc(ks + pn * BN * SW + w * 32, 16, 8 * SW, C::LAYOUT);
        wgmma_ss<BN>(sacc, da, db, kk > 0);
      }
      wgmma_commit();
      wgmma_wait0();
      pin<BN / 2>(sacc);

      // scale (and softcap) into log2 units, mask, online softmax
      const bool masked = t0 + BN - 1 > all_hi || t0 < all_lo;
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = sacc[4 * j + e] * qk_scale;
          if (p.softcap > 0.f) x = tanhf(x) * cap_scale;
          if (masked) {
            const int key = t0 + 8 * j + col + (e & 1);
            if (key > hi[e >> 1] || key < lo[e >> 1]) x = NEG;
          }
          sacc[4 * j + e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      float alpha[2], rsum[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        alpha[r] = exp2f(m[r] - mx[r]);
        m[r] = mx[r];
      }
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float pr = exp2f(sacc[4 * j + e] - m[e >> 1]);
          sacc[4 * j + e] = pr;
          rsum[e >> 1] += pr;
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rsum[r];
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        oacc[4 * j] *= alpha[0];
        oacc[4 * j + 1] *= alpha[0];
        oacc[4 * j + 2] *= alpha[1];
        oacc[4 * j + 3] *= alpha[1];
      }
      // P as the A operand, in two bf16 parts: k-step kk of 16 keys is S
      // chunks 2 kk and 2 kk + 1
      uint32_t pa[BN / 4], pl[BN / 4];
#pragma unroll
      for (int u = 0; u < BN / 4; ++u) split_bf16(sacc[2 * u], sacc[2 * u + 1], pa[u], pl[u]);
      pin<D / 2>(oacc);
      pin<BN / 4>(pa);
      pin<BN / 4>(pl);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {  // V: 16 key rows per k-step, panels of SW bytes
        const uint64_t dv = gmma_desc(vs + kk * 16 * SW, BN * SW, 8 * SW, C::LAYOUT);
        if constexpr (D == 256) {  // V's panels 0-1, then 2-3
          const uint64_t dv2 = gmma_desc(vs + 2 * BN * SW + kk * 16 * SW, BN * SW, 8 * SW,
                                         C::LAYOUT);
          wgmma_rs_n256(oacc, &pa[4 * kk], dv, dv2);
          wgmma_rs_n256(oacc, &pl[4 * kk], dv, dv2);
        } else {
          wgmma_rs<D>(oacc, &pa[4 * kk], dv);
          wgmma_rs<D>(oacc, &pl[4 * kk], dv);
        }
      }
      wgmma_commit();
      wgmma_wait0();
      pin<D / 2>(oacc);
    }
    if (lane == 0) mbar_arrive(empty0 + 8 * st);  // this warp is done with the stage
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int s = row + 8 * r;
    if (s >= p.S) continue;
    const bool sees = row_sees(s, p.T, off, p.causal, p.window);
    const float inv = sees ? 1.f / fmaxf(l[r], 1e-20f) : 0.f;
    __nv_bfloat16* orow = o + (((long long)b * p.S + s) * p.H + h) * D + col;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(orow + 8 * j) =
          pack_bf16(oacc[4 * j + 2 * r] * inv, oacc[4 * j + 2 * r + 1] * inv);
    if (p.lse != nullptr && col == 0)  // m is in log2 units
      p.lse[((long long)b * p.H + h) * p.S + s] =
          sees ? (m[r] + log2f(fmaxf(l[r], 1e-20f))) * LN2 : -INFINITY;
  }
}

constexpr int ERR_NO_ENCODER = -1;  // returned as launch codes; see flash_attention_error_string
constexpr int ERR_TENSOR_MAP = -2;

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, int B, int S,
           int T_len, int H, int KH, Strides qs, Strides ks, Strides vs, float scale,
           float softcap, int causal, int window, int diag, cudaStream_t stream) {
  using C = Cfg<D>;
  static bool ready = false;
  if (!ready) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    ready = true;
  }
  if (encoder() == nullptr) return ERR_NO_ENCODER;
  CUtensorMap qm, km, vm;
  if (!tensor_map(&qm, q, D, S, H, B, qs.s, qs.h, qs.b, ROWS, C::SW) ||
      !tensor_map(&km, k, D, T_len, KH, B, ks.s, ks.h, ks.b, C::BN, C::SW) ||
      !tensor_map(&vm, v, D, T_len, KH, B, vs.s, vs.h, vs.b, C::BN, C::SW))
    return ERR_TENSOR_MAP;
  const int n_qtiles = (S + C::NWG * ROWS - 1) / (C::NWG * ROWS);
  const Params p{S, T_len, H, KH, n_qtiles, scale, softcap, causal, window, diag, lse};
  flash_fwd_wgmma<D><<<dim3(H, n_qtiles, B), C::THREADS, C::SMEM, stream>>>(
      qm, km, vm, static_cast<__nv_bfloat16*>(o), p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wg

// ------------------------------------------------ route B: decode split over keys
namespace split {

constexpr int THREADS = 128;  // four warps
constexpr int BK = 32;        // keys per tile: 8 per warp in the scores
constexpr int STAGES = 3;     // cp.async ring
constexpr int ROWS = 16;      // the mma's m: the rows (query, head of the group) a block takes
constexpr int MAX_SPLITS = 64;

struct Params {
  int S, T, H, KH;
  Strides qs, ks, vs;
  float scale, softcap;
  int causal, window, diag;
  int key0, chunk, n_splits;
  float* lse;  // (B, H, S) or null
};

// The K/V ring [STAGES][K, V][BK][D + 8] and P's two parts [2][ROWS][BK + 8],
// bf16 (rows padded by 16 bytes: the ldmatrix row addresses fall in
// distinct banks), then a [4 warps][ROWS] f32 exchange of row maxima and
// sums.  55,040 bytes at d = 128: four blocks an SM.
template <int D>
__host__ __device__ constexpr int smem_bytes() {
  return (STAGES * 2 * BK * (D + 8) + 2 * ROWS * (BK + 8)) * 2 + 4 * ROWS * 4;
}

// d (16 x 8, f32) += a (16 x 16, bf16, row) b (16 x 8, bf16, col)
__device__ __forceinline__ void mma16816(float* d, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8 x 8 bf16 matrices; lane i names row i % 8 of matrix i / 8.
__device__ __forceinline__ void ldsm4(uint32_t* r, const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(row)));
}
__device__ __forceinline__ void ldsm4_t(uint32_t* r, const void* row) {  // transposed
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(row)));
}

// One block of four warps per (chunk, batch x KV head).  Row r < S G of
// the block is query r / G of head kh G + r % G (rows past S G are zeros
// and never stored).  In the mma fragments this thread holds rows
// g = lane / 4 and g + 8.  Scores: warp w takes keys 8 w .. 8 w + 7 of
// the tile; the tile's row maxima meet in shared memory; P (bf16) goes
// through shared memory; P V: warp w takes output columns w D/4 ..
template <int D, bool GENERAL>
__global__ void __launch_bounds__(THREADS)
    flash_fwd_split(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                    float* __restrict__ part, float* __restrict__ ml, int* __restrict__ tickets,
                    Params p) {
  constexpr int LD = D + 8, LDP = BK + 8;
  constexpr int NT = D / 32;  // a warp's 8-column tiles in P V
  extern __shared__ float4 smem4[];
  __nv_bfloat16* KV = reinterpret_cast<__nv_bfloat16*>(smem4);  // [STAGES][K, V][BK][LD]
  __nv_bfloat16* Ps = KV + STAGES * 2 * BK * LD;                  // [hi, lo][ROWS][LDP]
  float* red = reinterpret_cast<float*>(Ps + 2 * ROWS * LDP);     // [4][ROWS]
  __shared__ int last;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t4 = lane % 4;
  const int split = blockIdx.x, bk = blockIdx.y, b = bk / p.KH, kh = bk % p.KH;
  const int G = p.H / p.KH, rows = p.S * G, off = GENERAL ? p.diag : p.T - p.S;
  const int c0 = p.key0 + split * p.chunk;
  const int c1 = min(c0 + p.chunk, p.T);
  const int n_tiles = (c1 - c0 + BK - 1) / BK;

  auto load = [&](int i) {  // tile i of the chunk into stage i % STAGES; rows past c1 zeros
    if (i < n_tiles) {
      __nv_bfloat16* kd = KV + (i % STAGES) * 2 * BK * LD;
      __nv_bfloat16* vd = kd + BK * LD;
#pragma unroll 1  // unrolled, its hoisted addresses spill at 128 registers
      for (int u = tid; u < BK * D / 8; u += THREADS) {
        const int j = u / (D / 8), c = (u % (D / 8)) * 8;
        const long long t = c0 + i * BK + j;
        const bool in = t < c1;
        cp_async16(kd + j * LD + c, in ? k + b * p.ks.b + t * p.ks.s + kh * p.ks.h + c : k, in);
        cp_async16(vd + j * LD + c, in ? v + b * p.vs.b + t * p.vs.s + kh * p.vs.h + c : v, in);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) load(i);

  // Q as the A operand, straight from global memory, and each row's
  // visible keys lo <= key <= hi inside the chunk
  uint32_t qa[D / 16][4];
  int hi[2], lo[2];
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const int r = g + 8 * h2;
    const __nv_bfloat16* qr =
        q + b * p.qs.b + (r / G) * p.qs.s + (kh * G + r % G) * p.qs.h + 2 * t4;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      qa[kk][h2] = r < rows ? __ldg(reinterpret_cast<const unsigned int*>(qr + 16 * kk)) : 0u;
      qa[kk][h2 + 2] =
          r < rows ? __ldg(reinterpret_cast<const unsigned int*>(qr + 16 * kk + 8)) : 0u;
    }
    const int s = r < rows ? r / G : p.S - 1;
    hi[h2] = p.causal ? min(c1 - 1, s + off) : c1 - 1;
    lo[h2] = p.window > 0 ? s + off - p.window + 1 : 0;
  }
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};  // l: this thread's keys only
  float oacc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[n][e] = 0.f;

  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // tile i is in; every thread is done with tile i - 1
    load(i + STAGES - 1);
    const __nv_bfloat16* kt = KV + (i % STAGES) * 2 * BK * LD;
    const __nv_bfloat16* vt = kt + BK * LD;

    float sc[4] = {0.f, 0.f, 0.f, 0.f};  // rows g, g + 8 x keys 8 warp + 2 t4 + {0, 1}
#pragma unroll
    for (int kk = 0; kk < D / 16; kk += 2) {
      uint32_t kb[4];
      ldsm4(kb, kt + (8 * warp + lane % 8) * LD + 16 * kk + 8 * (lane / 8));
      mma16816(sc, qa[kk], kb[0], kb[1]);
      mma16816(sc, qa[kk + 1], kb[2], kb[3]);
    }
    const int key = c0 + i * BK + 8 * warp + 2 * t4;
    float mx[2] = {NEG, NEG};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = sc[e] * p.scale;
      if (p.softcap > 0.f) x = tanhf(x / p.softcap) * p.softcap;
      const int kj = key + (e & 1);
      if (kj > hi[e >> 1] || kj < lo[e >> 1]) x = NEG;
      sc[e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    }
    if (t4 == 0) {
      red[warp * ROWS + g] = mx[0];
      red[warp * ROWS + g + 8] = mx[1];
    }
    __syncthreads();
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = g + 8 * r;
      const float m_new = fmaxf(fmaxf(m[r], fmaxf(red[row], red[ROWS + row])),
                                fmaxf(red[2 * ROWS + row], red[3 * ROWS + row]));
      alpha[r] = expf(m[r] - m_new);
      m[r] = m_new;
    }
    float pr[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) pr[e] = expf(sc[e] - m[e >> 1]);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] = l[r] * alpha[r] + pr[2 * r] + pr[2 * r + 1];
      uint32_t* at = reinterpret_cast<uint32_t*>(Ps + (g + 8 * r) * LDP + 8 * warp + 2 * t4);
      split_bf16(pr[2 * r], pr[2 * r + 1], at[0], at[ROWS * LDP / 2]);
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      oacc[n][0] *= alpha[0];
      oacc[n][1] *= alpha[0];
      oacc[n][2] *= alpha[1];
      oacc[n][3] *= alpha[1];
    }
    __syncthreads();

    uint32_t pa[2][2][4];  // P's two parts x two k-steps of 16 keys
#pragma unroll
    for (int piece = 0; piece < 2; ++piece)
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
        ldsm4(pa[piece][kk], Ps + piece * ROWS * LDP +
                                 (lane % 8 + 8 * ((lane / 8) % 2)) * LDP + 16 * kk +
                                 8 * (lane / 16));
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      uint32_t vb[4];  // keys 0-7, 8-15, 16-23, 24-31 of 8 columns, transposed
      ldsm4_t(vb, vt + lane * LD + warp * (D / 4) + 8 * n);
#pragma unroll
      for (int piece = 0; piece < 2; ++piece) {
        mma16816(oacc[n], pa[piece][0], vb[0], vb[1]);
        mma16816(oacc[n], pa[piece][1], vb[2], vb[3]);
      }
    }
  }
  cp_async_wait<0>();

  // the row sums over the quad, then over the four warps (every read of red
  // in the loop came before the last tile's second barrier)
  float lsum[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  if (t4 == 0) {
    red[warp * ROWS + g] = l[0];
    red[warp * ROWS + g + 8] = l[1];
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = g + 8 * r;
    lsum[r] = red[row] + red[ROWS + row] + red[2 * ROWS + row] + red[3 * ROWS + row];
  }
  const int col = warp * (D / 4) + 2 * t4;

  if (p.n_splits == 1) {  // the whole range in one block: normalise and store
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = g + 8 * r;
      if (row >= rows) continue;
      const bool sees = !GENERAL || row_sees(row / G, p.T, off, p.causal, p.window);
      const float inv = sees ? 1.f / fmaxf(lsum[r], 1e-20f) : 0.f;
      __nv_bfloat16* orow =
          o + (((long long)b * p.S + row / G) * p.H + kh * G + row % G) * D + col;
#pragma unroll
      for (int n = 0; n < NT; ++n)
        *reinterpret_cast<uint32_t*>(orow + 8 * n) =
            pack_bf16(oacc[n][2 * r] * inv, oacc[n][2 * r + 1] * inv);
      if (p.lse != nullptr && col == 0)
        p.lse[((long long)b * p.H + kh * G + row % G) * p.S + row / G] =
            sees ? m[r] + logf(fmaxf(lsum[r], 1e-20f)) : -INFINITY;
    }
    return;
  }

  // the partial (m, l, acc) of this chunk
  const long long slot = (long long)bk * p.n_splits + split;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = g + 8 * r;
    if (row >= rows) continue;
    float* dst = part + (slot * ROWS + row) * D + col;
#pragma unroll
    for (int n = 0; n < NT; ++n)
      *reinterpret_cast<float2*>(dst + 8 * n) = make_float2(oacc[n][2 * r], oacc[n][2 * r + 1]);
    if (warp == 0 && t4 == 0) {
      ml[(slot * ROWS + row) * 2] = m[r];
      ml[(slot * ROWS + row) * 2 + 1] = lsum[r];
    }
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(&tickets[bk], 1) == p.n_splits - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();

  // the last block merges: weight exp(m_i - max m) per chunk and row
  float* W = reinterpret_cast<float*>(KV);  // [n_splits][ROWS], over the spent ring
  const long long first = (long long)bk * p.n_splits;
#pragma unroll
  for (int r0 = 0; r0 < ROWS / 4; ++r0) {
    const int row = warp * (ROWS / 4) + r0;
    if (row >= rows) break;
    float mg = NEG;
    for (int i = lane; i < p.n_splits; i += 32)
      mg = fmaxf(mg, __ldcg(ml + ((first + i) * ROWS + row) * 2));
#pragma unroll
    for (int w = 16; w > 0; w >>= 1) mg = fmaxf(mg, __shfl_xor_sync(0xffffffffu, mg, w));
    float lg = 0.f;
    for (int i = lane; i < p.n_splits; i += 32) {
      const float wt = expf(__ldcg(ml + ((first + i) * ROWS + row) * 2) - mg);
      W[i * ROWS + row] = wt;
      lg += wt * __ldcg(ml + ((first + i) * ROWS + row) * 2 + 1);
    }
#pragma unroll
    for (int w = 16; w > 0; w >>= 1) lg += __shfl_xor_sync(0xffffffffu, lg, w);
    const bool sees = !GENERAL || row_sees(row / G, p.T, off, p.causal, p.window);
    if (lane == 0) red[row] = sees ? 1.f / fmaxf(lg, 1e-20f) : 0.f;  // red is spent too
    if (lane == 0 && p.lse != nullptr)
      p.lse[((long long)b * p.H + kh * G + row % G) * p.S + row / G] =
          sees ? mg + logf(fmaxf(lg, 1e-20f)) : -INFINITY;
  }
  __syncthreads();
  // thread tid sums element e THREADS + tid of the ROWS x D partials, for
  // each e (at D <= THREADS: column tid % D of rows tid / D + e THREADS / D;
  // at D = 256, columns tid and tid + 128 of each row)
  constexpr int E = ROWS * D / THREADS;
  float x[E];
#pragma unroll
  for (int e = 0; e < E; ++e) x[e] = 0.f;
#pragma unroll 4  // four chunks' loads in flight
  for (int i = 0; i < p.n_splits; ++i) {
    const float* src = part + (first + i) * ROWS * D + tid;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int row = (e * THREADS + tid) / D;
      if (row < rows) x[e] = fmaf(W[i * ROWS + row], __ldcg(src + e * THREADS), x[e]);
    }
  }
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int row = (e * THREADS + tid) / D, c = (e * THREADS + tid) % D;
    if (row < rows)
      o[(((long long)b * p.S + row / G) * p.H + kh * G + row % G) * D + c] =
          __float2bfloat16(x[e] * red[row]);
  }
  if (tid == 0) tickets[bk] = 0;  // ready for the next launch on the stream
}

template <int D, bool GENERAL>
int launch_diag(const void* q, const void* k, const void* v, void* o, int B, const Params& p,
                float* part, float* ml, int* tickets, cudaStream_t stream) {
  constexpr int smem = smem_bytes<D>();
  static bool ready = false;
  if (!ready) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_split<D, GENERAL>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    ready = true;
  }
  flash_fwd_split<D, GENERAL><<<dim3(p.n_splits, B * p.KH), THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), part, ml, tickets,
      p);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, const Params& p,
           float* part, float* ml, int* tickets, cudaStream_t stream) {
  if (p.diag == p.T - p.S)
    return launch_diag<D, false>(q, k, v, o, B, p, part, ml, tickets, stream);
  return launch_diag<D, true>(q, k, v, o, B, p, part, ml, tickets, stream);
}

}  // namespace split

// ------------------------------------------------ entry points
namespace {

bool shape_ok(int B, int S, int T_len, int H, int KH, int causal, int window) {
  return B > 0 && S > 0 && T_len > 0 && KH > 0 && H % KH == 0 && !(window > 0 && !causal);
}

}  // namespace

// Route C, f32 only.  Strides are in elements; softcap <= 0 means none;
// window <= 0 means global; query i sees key j iff j <= i + diag (causal;
// T - S end-aligns them); lse, when not null, receives each row's
// log-sum-exp, f32 (B, H, S).  Returns the launch's cudaError_t (0 on
// success).
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                                      int B, int S, int T_len, int H, int KH, int D,
                                      long long q_sb, long long q_ss, long long q_sh,
                                      long long k_sb, long long k_st, long long k_sh,
                                      long long v_sb, long long v_st, long long v_sh,
                                      float scale, float softcap, int causal, int window,
                                      int diag, void* lse, void* stream) {
  if (!shape_ok(B, S, T_len, H, KH, causal, window) || B * KH > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_st, k_sh}, vs{v_sb, v_st, v_sh};
  return launch_dim(q, k, v, o, static_cast<float*>(lse), B, S, T_len, H, KH, D, qs, ks, vs,
                    scale, softcap, causal, window, diag, static_cast<cudaStream_t>(stream));
}

// Route A, bf16 only; the arguments as for route C.
extern "C" int flash_attention_wgmma_launch(const void* q, const void* k, const void* v, void* o,
                                            int B, int S, int T_len, int H, int KH, int D,
                                            long long q_sb, long long q_ss, long long q_sh,
                                            long long k_sb, long long k_st, long long k_sh,
                                            long long v_sb, long long v_st, long long v_sh,
                                            float scale, float softcap, int causal, int window,
                                            int diag, void* lse, void* stream) {
  if (!shape_ok(B, S, T_len, H, KH, causal, window) || B > 65535 || H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_st, k_sh}, vs{v_sb, v_st, v_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* ls = static_cast<float*>(lse);
  switch (D) {
    case 32:
      return wg::launch<32>(q, k, v, o, ls, B, S, T_len, H, KH, qs, ks, vs, scale, softcap,
                            causal, window, diag, s);
    case 64:
      return wg::launch<64>(q, k, v, o, ls, B, S, T_len, H, KH, qs, ks, vs, scale, softcap,
                            causal, window, diag, s);
    case 128:
      return wg::launch<128>(q, k, v, o, ls, B, S, T_len, H, KH, qs, ks, vs, scale, softcap,
                             causal, window, diag, s);
    case 256:
      return wg::launch<256>(q, k, v, o, ls, B, S, T_len, H, KH, qs, ks, vs, scale, softcap,
                             causal, window, diag, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Route B, bf16 only, S (H / KH) <= 16.  Split n of n_splits covers keys
// [key0 + n chunk, min(key0 + (n + 1) chunk, T_len)).  With n_splits > 1,
// part holds B KH n_splits 16 D floats, ml B KH n_splits 16 2, and tickets
// B KH ints, zero on entry and left zero.
extern "C" int flash_attention_split_launch(const void* q, const void* k, const void* v, void* o,
                                            int B, int S, int T_len, int H, int KH, int D,
                                            long long q_sb, long long q_ss, long long q_sh,
                                            long long k_sb, long long k_st, long long k_sh,
                                            long long v_sb, long long v_st, long long v_sh,
                                            float scale, float softcap, int causal, int window,
                                            int diag, int key0, int chunk, int n_splits, void* part,
                                            void* ml, void* tickets, void* lse, void* stream) {
  if (!shape_ok(B, S, T_len, H, KH, causal, window) || S * (H / KH) > split::ROWS ||
      B * KH > 65535 || n_splits < 1 || n_splits > split::MAX_SPLITS || chunk < 1 ||
      key0 < 0 || key0 + (long long)(n_splits - 1) * chunk >= T_len ||
      (n_splits > 1 && (part == nullptr || ml == nullptr || tickets == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const split::Params p{S, T_len, H, KH, {q_sb, q_ss, q_sh}, {k_sb, k_st, k_sh},
                        {v_sb, v_st, v_sh}, scale, softcap, causal, window, diag, key0,
                        chunk, n_splits, static_cast<float*>(lse)};
  float* pt = static_cast<float*>(part);
  float* mlp = static_cast<float*>(ml);
  int* tk = static_cast<int*>(tickets);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32:
      return split::launch<32>(q, k, v, o, B, p, pt, mlp, tk, s);
    case 64:
      return split::launch<64>(q, k, v, o, B, p, pt, mlp, tk, s);
    case 128:
      return split::launch<128>(q, k, v, o, B, p, pt, mlp, tk, s);
    case 256:
      return split::launch<256>(q, k, v, o, B, p, pt, mlp, tk, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* flash_attention_error_string(int code) {
  if (code == wg::ERR_NO_ENCODER) return "the driver has no cuTensorMapEncodeTiled";
  if (code == wg::ERR_TENSOR_MAP) return "cuTensorMapEncodeTiled refused a K, V or Q view";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
