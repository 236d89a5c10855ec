// trie_walk: the fused trie walk of the serving path, one launch per
// query batch whatever the trie's depth.
//
// Replaces the TPU kernel
//   repro/kernels/trie_walk/trie_walk.py::trie_walk_blocked
// and computes, bit for bit, the plain version
//   repro_torch/kernels/trie_walk/ref.py::trie_walk_core
// on the tables that repro_torch/kernels/trie_walk/ops.py::trie_walk_cells
// gathers by cell.  For each (sequence, subtree shard) cell it walks the
// shard's S slots in topological order.  Slot n seeds from its parent
// slot's frontier (or the root state when parent < 0), applies the
// residual-req prescreen, takes one embedding-join step - window gather
// through the inverted index, the containment predicate
// (contain_pred.cuh, shared with containment.cu), first-E compaction in
// (row, token, orientation) order, phi/psi update - and writes its
// terminal accept and terminal-overflow bits.
//
// Inputs (all int32, contiguous), read in place through cells:
//   tokens [B,T,6]  order [B,T]  start, count [B,K]      (by cells[i,0])
//   steps_s [Sp,S,8]  parent_s [Sp,S]  req_s [Sp,S,K]    (by cells[i,1])
//   cells [N,2]
// Outputs: acc, ovft [N,S] (bytes 0/1: torch.bool).
//
// What bounds it on the card: the work of a cell is small (S slots of
// E*Tm predicate pairs, a compaction and an E*(ni+nv) update: a few
// thousand integer operations) and strictly serial from slot to slot,
// each slot behind a chain of dependent reads (parent -> frontier ->
// predicate -> compaction -> update).  Bytes and operations are both
// far below what the card could do: at the serving shape (16,384 cells,
// S = 8, emax 4, tmax 8) the bound is 1.6 us of operations, while the
// time goes to instruction issue and latency along each warp's chain.
// A block of 128 threads per cell would leave 96 threads idle in the
// predicate (32 pairs) and all but one in a serial compaction, put
// block barriers between the phases of every slot, and fit about 2,100
// cells on the card.
//
// Design: one warp per cell, 4 cells a block (fewer where a cell's
// buffers are large), no block barrier: the warp owns its slice of
// shared memory and __syncwarp orders its phases.
//  - The cell's tables are read in place through cells[i] (no per-cell
//    copies in front of the launch).  The prologue reads the shard's
//    step rows, parents and window starts and counts, and the residual
//    prescreen of every slot (count >= req on all K keys, lanes across
//    the keys, the req rows of 8 slots read before any is compared).
//  - Frontier buffers phi [S,E,ni], psi [S,E,nv] stay in shared memory;
//    after the compaction a slot's valid rows are exactly its first
//    n_sel rows, so a slot keeps the count n_sel, not a row mask.
//  - A slot that fails its prescreen costs one read: its flags stay
//    the prologue's zeros, so a child of it seeds no row and inherits
//    no overflow, as in the plain version.  A slot whose seed has no
//    valid row only passes the overflow on.  Neither reads its window
//    or evaluates a predicate, nor does a slot where no pair can match
//    (no valid token in its window, or cur_phi read as INT_MIN on a slot
//    that stays in its itemset): the prologue marks it with start -1 and
//    normalises the step key and idx once a slot, so the pair loop reads
//    what it read before the out-of-range rules (measured: no slower,
//    PERF.md).  Rows past n_sel are never read again, so they are not
//    written.
//  - The slot's E*Tm predicate pairs map onto the 32 lanes (looping past
//    32); candidate c = (e*Tm + t)*2 + o.  Compaction by ballot: per
//    group of 32 pairs, __ballot_sync of the two orientation bits, and
//    a flagged candidate's rank is the running count plus __popc of the
//    lower lanes' bits - the (row, token, orientation) order exactly.
//    The walk of the pairs stops once the count passes E; the (E+1)-th
//    candidate is the frontier overflow.
//  - The outputs are bytes, so the wrapper hands them out as torch.bool
//    with no cast after the kernel.
// Measured alternatives that were slower at the serving shape: reading
// every slot's window in the prologue (the slots' reads are not what the
// chain waits on), persistent warps striding over the cells (the cells'
// work is uneven), 8 warps a block, and fewer registers for more warps.
// Pad slots (step_valid 0, parent -1, req = int32 max) fail the
// prescreen and come out 0/0 with no special case; pad cells (the zero
// rows a batch is padded with) walk cell (0, 0).  Cell indices wrap
// once when negative and clamp into range, as JAX's gather does; the
// step key and the itemset slot idx are read as jnp.take_along_axis
// reads them (wrapped once when negative, INT_MIN past that), so a key
// out of range opens no window and no step row reads out of bounds
// (start, count and order are the inverted index's: starts in [0, T],
// order a permutation of [0, T)).  The
// launcher returns the CUDA error when a cell's buffers exceed what one
// block may have; the wrapper raises on it.
#include <cuda_runtime.h>

#include <climits>

#include "contain_pred.cuh"

namespace {

constexpr int kWarp = 32;
constexpr int kMaxWarps = 4;
constexpr int kBatch = 8;  // slots whose prescreen reads are issued together
constexpr unsigned kFull = 0xffffffffu;
constexpr int kPadPhi = 0x3FFFFFF;
constexpr int kPadPsi = -2;

struct Sizes {
  int B, T, K, Sp, S, E, Tm, ni, nv;
};

// offsets (in ints) of one warp's slice of shared memory, and its size
// in 64 bits: the launcher refuses a slice too large for a block before
// the int offsets are used
struct Layout {
  int steps, parent, poss, st, ct, cc, nvalid, ovf, acc, ovft, root_phi,
      root_psi, phi, psi, tok_w, sel;
  long long total;
};

Layout make_layout(const Sizes& z) {
  Layout l;
  long long o = 0;
  auto take = [&o](long long n) {
    const int at = static_cast<int>(o);
    o += n;
    return at;
  };
  const long long S = z.S, E = z.E;
  l.steps = take(S * contain::kSrowFields);
  l.parent = take(S);
  l.poss = take(S);
  l.st = take(S);
  l.ct = take(S);
  l.cc = take(S);
  l.nvalid = take(S);
  l.ovf = take(S);
  l.acc = take(S);
  l.ovft = take(S);
  l.root_phi = take(z.ni);
  l.root_psi = take(z.nv);
  l.phi = take(S * E * z.ni);
  l.psi = take(S * E * z.nv);
  l.tok_w = take(6LL * z.Tm);
  l.sel = take(2 * E);
  l.total = o;
  return l;
}

// a gather index as JAX takes it: wrapped once when negative, clamped
__device__ __forceinline__ int wrap_clamp(int x, int n) {
  if (x < 0) x += n;
  return x < 0 ? 0 : (x > n - 1 ? n - 1 : x);
}

__global__ void __launch_bounds__(kWarp * kMaxWarps)
trie_walk_kernel(const int* __restrict__ tokens, const int* __restrict__ order,
                 const int* __restrict__ start, const int* __restrict__ count,
                 const int* __restrict__ cells,
                 const int* __restrict__ steps_s,
                 const int* __restrict__ parent_s,
                 const int* __restrict__ req_s,
                 unsigned char* __restrict__ acc,
                 unsigned char* __restrict__ ovft, int N, Sizes z,
                 Layout L) {
  const int lane = threadIdx.x & (kWarp - 1);
  const int warp = threadIdx.x / kWarp;
  const long long i =
      static_cast<long long>(blockIdx.x) * (blockDim.x / kWarp) + warp;
  if (i >= N) return;  // the whole warp: no block barrier follows
  const int T = z.T, K = z.K, S = z.S, E = z.E, Tm = z.Tm, ni = z.ni,
            nv = z.nv;
  extern __shared__ int smem[];
  int* const w = smem + static_cast<long long>(warp) * L.total;
  int* const s_steps = w + L.steps;
  int* const s_parent = w + L.parent;
  int* const s_poss = w + L.poss;
  int* const s_st = w + L.st;
  int* const s_ct = w + L.ct;
  int* const s_cc = w + L.cc;
  int* const s_nvalid = w + L.nvalid;
  int* const s_ovf = w + L.ovf;
  int* const s_acc = w + L.acc;
  int* const s_ovft = w + L.ovft;
  int* const root_phi = w + L.root_phi;
  int* const root_psi = w + L.root_psi;
  int* const phi_buf = w + L.phi;
  int* const psi_buf = w + L.psi;
  int* const tok_w = w + L.tok_w;
  int* const sel = w + L.sel;

  // ---- the cell's sequence and subtree, read in place
  const int b = wrap_clamp(__ldg(cells + 2 * i), z.B);
  const int s = wrap_clamp(__ldg(cells + 2 * i + 1), z.Sp);
  const int* const tok = tokens + static_cast<long long>(b) * T * 6;
  const int* const ord = order + static_cast<long long>(b) * T;
  const int* const st_row = start + static_cast<long long>(b) * K;
  const int* const ct_row = count + static_cast<long long>(b) * K;
  const int* const stp =
      steps_s + static_cast<long long>(s) * S * contain::kSrowFields;
  const int* const par = parent_s + static_cast<long long>(s) * S;
  const int* const rq = req_s + static_cast<long long>(s) * S * K;

  // ---- prologue: step rows, parents, window starts and counts
  for (int q = lane; q < S * contain::kSrowFields; q += kWarp)
    s_steps[q] = __ldg(stp + q);
  for (int n = lane; n < S; n += kWarp) {
    const int* const row = stp + n * contain::kSrowFields;
    // the step key and itemset slot as JAX's take_along_axis takes them:
    // wrapped once when in [-K, 0) / [-ni, 0); any other key reads INT_MIN
    // as start and count (no window, no window overflow), any other idx
    // INT_MIN as cur_phi
    int key = __ldg(row + 7);
    if (key < 0) key += K;
    const bool kin = key >= 0 && key < K;
    const int st = kin ? __ldg(st_row + key) : INT_MIN;
    const int ct = kin ? __ldg(ct_row + key) : INT_MIN;
    const int idx = __ldg(row + 5);
    const int ci = idx < 0 ? idx + ni : idx;
    const bool cin = ci >= 0 && ci < ni;
    // a slot whose window holds no valid token (ct <= 0, as for a key
    // read as INT_MIN) matches nothing, nor does one that stays in its
    // itemset with cur_phi INT_MIN (j == INT_MIN holds for no valid
    // token): the plain version's predicate is 0 on every pair, as on a
    // padding row, so such a slot gets start -1 and neither reads its
    // window nor joins.  A window with valid tokens starts in [0, T) (the
    // inverted index's starts do); a start outside it is not read either.
    const bool joins = ct > 0 && st >= 0 && st < T &&
                       (__ldg(row + 4) > 0 || cin);
    s_parent[n] = __ldg(par + n);
    s_st[n] = joins ? st : -1;
    s_ct[n] = ct;
    // cur_phi's column; a slot that opens an itemset never uses it
    s_cc[n] = cin ? ci : 0;
    // what a slot that never joins leaves: no row, no overflow
    s_nvalid[n] = 0;
    s_ovf[n] = 0;
    s_acc[n] = 0;
    s_ovft[n] = 0;
  }
  for (int c = lane; c < ni; c += kWarp) root_phi[c] = kPadPhi;
  for (int c = lane; c < nv; c += kWarp) root_psi[c] = kPadPsi;
  // residual prescreen of every slot, lanes across the keys: a slot
  // dies on any key with count < req.  The req rows of kBatch slots are
  // read before any is compared, so that the reads overlap.
  for (int n0 = 0; n0 < S; n0 += kBatch) {
    unsigned bad[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) bad[u] = 0;
    for (int k0 = 0; k0 < K; k0 += kWarp) {
      const int k = k0 + lane;
      const bool kin = k < K;
      const int cnt = kin ? __ldg(ct_row + k) : 0;
      int rv[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        rv[u] = kin && n0 + u < S
                    ? __ldg(rq + static_cast<long long>(n0 + u) * K + k)
                    : INT_MIN;
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        bad[u] |= __ballot_sync(kFull, cnt < rv[u]);
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      if (lane == u && n0 + u < S) s_poss[n0 + u] = bad[u] == 0;
  }
  __syncwarp();

  // a lane's first predicate pair and first update cells, divided once
  const int e_first = lane / Tm, t_first = lane - e_first * Tm;
  const int r_phi = lane / ni, c_phi = lane - r_phi * ni;
  const int r_psi = lane / nv, c_psi = lane - r_psi * nv;
  const unsigned lower = (1u << lane) - 1u;

  for (int n = 0; n < S; ++n) {
    // a slot that fails its prescreen keeps the prologue's zeros, so a
    // slot below it seeds no row and no overflow from it
    if (!s_poss[n]) continue;
    const int pidx = s_parent[n];
    const bool isroot = pidx < 0;
    const int pcl = pidx < 0 ? 0 : (pidx > S - 1 ? S - 1 : pidx);
    // a parent slot not yet walked has the plain version's zero buffers:
    // no valid row and no overflow
    const bool seen = !isroot && pcl < n;
    const int seed_n = isroot ? 1 : (seen ? s_nvalid[pcl] : 0);
    const bool seed_ovf = seen && s_ovf[pcl] != 0;
    if (seed_n == 0) {  // no row to extend: only the overflow carries on
      if (seed_ovf) {
        s_ovf[n] = 1;
        s_ovft[n] = 1;
        __syncwarp();
      }
      continue;
    }
    int n_sel = 0;
    bool f_ovf = false;
    const int* const step = s_steps + n * contain::kSrowFields;
    const int ty = step[0], pu1 = step[1], pu2 = step[2], lab = step[3];
    const int snew = step[4], idx = step[5], sval = step[6];
    const int st = s_st[n], ct = s_ct[n];
    const bool w_ovf = ct > Tm;
    const int* const seed_phi = isroot ? root_phi : phi_buf + pcl * E * ni;
    const int* const seed_psi = isroot ? root_psi : psi_buf + pcl * E * nv;
    if (sval > 0 && st >= 0) {  // st is -1 where no pair can match
      // ---- the step's token window through the inverted index (order is
      // a permutation of [0, T))
      for (int m = lane; m < Tm; m += kWarp) {
        const int wpos = st + m < T - 1 ? st + m : T - 1;
        const int* const src =
            tok + static_cast<long long>(__ldg(ord + wpos)) * 6;
        int* const dst = tok_w + m * 6;
#pragma unroll
        for (int f = 0; f < 5; ++f) dst[f] = __ldg(src + f);
        dst[5] = m < ct ? __ldg(src + 5) : 0;
      }
      __syncwarp();
      // ---- predicate over (valid row, token) pairs, ballot compaction;
      // prev_phi's index is clipped and used only when idx > 0
      const int pi = idx > ni ? ni - 1 : (idx > 0 ? idx - 1 : 0);
      const int cc = s_cc[n];
      const int npairs = seed_n * Tm;
      int cnt = 0;
      for (int base = 0; base < npairs && cnt <= E; base += kWarp) {
        const int k = base + lane;
        int bits = 0, e = 0, t = 0;
        if (k < npairs) {
          if (base == 0) {
            e = e_first;
            t = t_first;
          } else {
            e = k / Tm;
            t = k - e * Tm;
          }
          const int* const ph = seed_phi + e * ni;
          int srow[contain::kSrowFields];
          srow[0] = ty; srow[1] = pu1; srow[2] = pu2; srow[3] = lab;
          srow[4] = snew;
          srow[5] = idx > 0 ? ph[pi] : -1;
          srow[6] = ph[cc];
          srow[7] = 1;  // e < seed_n and sval > 0
          bits = contain::contain_pred(tok_w + t * 6, seed_psi + e * nv,
                                       nv, srow);
        }
        const unsigned b0 = __ballot_sync(kFull, bits & 1);
        const unsigned b1 = __ballot_sync(kFull, bits & 2);
        int rank = cnt + __popc(b0 & lower) + __popc(b1 & lower);
        if (bits & 1) {
          if (rank < E) {
            sel[2 * rank] = e;
            sel[2 * rank + 1] = 2 * t;
          }
          ++rank;
        }
        if ((bits & 2) && rank < E) {
          sel[2 * rank] = e;
          sel[2 * rank + 1] = 2 * t + 1;
        }
        cnt += __popc(b0) + __popc(b1);
      }
      n_sel = cnt < E ? cnt : E;
      f_ovf = cnt > E;
      __syncwarp();
      // ---- phi / psi of the kept rows into slot n's buffer row
      int* const out_phi = phi_buf + n * E * ni;
      for (int q = lane; q < n_sel * ni; q += kWarp) {
        const int r = q == lane ? r_phi : q / ni;
        const int c = q == lane ? c_phi : q - r * ni;
        int v = seed_phi[sel[2 * r] * ni + c];
        if (c == idx && snew > 0) v = tok_w[(sel[2 * r + 1] >> 1) * 6 + 4];
        out_phi[q] = v;
      }
      const bool is_v = ty <= 2;
      int* const out_psi = psi_buf + n * E * nv;
      for (int q = lane; q < n_sel * nv; q += kWarp) {
        const int r = q == lane ? r_psi : q / nv;
        const int c = q == lane ? c_psi : q - r * nv;
        const int to = sel[2 * r + 1];
        const int* const tw = tok_w + (to >> 1) * 6;
        const int u1 = tw[1], u2 = tw[2];
        const int v0 = seed_psi[sel[2 * r] * nv + c];
        int v = v0;
        // the plain version's fresh tests read psi at pu1 / pu2 (INT_MIN,
        // so fresh, out of range), but its update masks by c == pu, so
        // only an in-range pu's own column, v0, decides
        if (c == pu1 && v0 < 0) v = is_v ? u1 : ((to & 1) ? u2 : u1);
        if (c == pu2 && !is_v && v0 < 0) v = (to & 1) ? u1 : u2;
        out_psi[q] = v;
      }
    }
    // every lane stores the same value
    s_nvalid[n] = n_sel;
    s_ovf[n] = seed_ovf || f_ovf || w_ovf;
    s_acc[n] = n_sel > 0;
    s_ovft[n] = seed_ovf || w_ovf;
    __syncwarp();
  }
  for (int n = lane; n < S; n += kWarp) {
    acc[i * S + n] = s_acc[n];
    ovft[i * S + n] = s_ovft[n];
  }
}

}  // namespace

// Plain C entry point, bound from Python with ctypes.  Launches on
// ``stream`` and returns cudaGetLastError() (0 when the launch was taken),
// or cudaErrorInvalidValue when one cell's buffers exceed what a block
// may have.
extern "C" int trie_walk_launch(const int* tokens, const int* order,
                                const int* start, const int* count,
                                const int* cells, const int* steps_s,
                                const int* parent_s, const int* req_s,
                                unsigned char* acc, unsigned char* ovft,
                                int N, int B, int T,
                                int K, int Sp, int S, int E, int Tm, int ni,
                                int nv, cudaStream_t stream) {
  if (N <= 0 || S <= 0) return 0;
  const Sizes z{B, T, K, Sp, S, E, Tm, ni, nv};
  const Layout layout = make_layout(z);
  const long long slice = 4 * layout.total;
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  if (slice > optin) return static_cast<int>(cudaErrorInvalidValue);
  // as many warps (cells) a block as fit the default 48 KB, at most 4
  long long warps = (48 * 1024) / slice;
  warps = warps < 1 ? 1 : (warps > kMaxWarps ? kMaxWarps : warps);
  const size_t smem = static_cast<size_t>(warps * slice);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        trie_walk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) {
      cudaGetLastError();  // clear it, or the next launch reports it
      return static_cast<int>(err);
    }
  }
  const long long blocks = (N + warps - 1) / warps;
  trie_walk_kernel<<<static_cast<unsigned>(blocks),
                     static_cast<unsigned>(warps * kWarp), smem, stream>>>(
      tokens, order, start, count, cells, steps_s, parent_s, req_s, acc,
      ovft, N, z, layout);
  return static_cast<int>(cudaGetLastError());
}
