// contain_pred: the Def-4 embedding-join predicate of one
// (frontier row, window token) pair, shared by the containment-step
// kernel (containment.cu) and the fused trie-walk kernel (trie_walk.cu).
//
// Computes, bit for bit, one element of the plain version
//   repro_torch/kernels/containment/ref.py::contain_step_core
// a 2-bit orientation mask: 0 = no match, bit0 = (pu1->u1, pu2->u2),
// bit1 = the swap (edge TRs only).
#pragma once

namespace contain {

constexpr int kBig = 0x3FFFFFF;
constexpr int kTokFields = 6;   // type, u1, u2, label, j, valid
constexpr int kSrowFields = 8;  // ty, pu1, pu2, label, new, prev, cur, valid

// tok: one token row (6 ints); psi: one frontier row (nv ints);
// srow: one step row (8 ints).  Any address space.
__device__ __forceinline__ int contain_pred(const int* tok, const int* psi,
                                            int nv, const int* srow) {
  const int t_ty = tok[0], u1 = tok[1], u2 = tok[2], t_lab = tok[3];
  const int j = tok[4];
  const bool t_val = tok[5] > 0;
  const int sty = srow[0], spu1 = srow[1], spu2 = srow[2], slab = srow[3];
  const int snew = srow[4], sprev = srow[5], scur = srow[6], sval = srow[7];

  const bool base = t_val && sval > 0 && t_ty == sty && t_lab == slab;
  const bool slot_ok = snew > 0 ? j > sprev : j == scur;
  if (!(base && slot_ok)) return 0;

  // masked-min psi lookups and the any-match injectivity tests, one pass
  int pvv1 = kBig, pvv2 = kBig;
  bool u1_mapped = false, u2_mapped = false;
  for (int c = 0; c < nv; ++c) {
    const int v = psi[c];
    if (c == spu1 && v < pvv1) pvv1 = v;
    if (c == spu2 && v < pvv2) pvv2 = v;
    u1_mapped |= v == u1;
    u2_mapped |= v == u2;
  }
  const bool bound1 = pvv1 >= 0 && pvv1 < kBig;
  const bool bound2 = pvv2 >= 0 && pvv2 < kBig;

  if (sty <= 2) {  // vertex TR: one orientation
    return (bound1 ? u1 == pvv1 : !u1_mapped) ? 1 : 0;
  }
  const bool distinct = bound1 || bound2 || u1 != u2;
  const bool e1_0 = bound1 ? u1 == pvv1 : !u1_mapped;
  const bool e2_0 = bound2 ? u2 == pvv2 : !u2_mapped;
  const bool e1_1 = bound1 ? u2 == pvv1 : !u2_mapped;
  const bool e2_1 = bound2 ? u1 == pvv2 : !u1_mapped;
  const int bit0 = (e1_0 && e2_0 && distinct) ? 1 : 0;
  const int bit1 = (e1_1 && e2_1 && distinct) ? 2 : 0;
  return bit0 | bit1;
}

}  // namespace contain
