// Host build of the fused extension lanes (banded_extend.h): the same
// arithmetic as the CUDA kernel in cuda/banded_extend.cu, run lane by lane
// on the CPU so the tests can compare it with ops/extend_ref and the plain
// XLA step.  Arrays use the device step's transposed layout: ql/qr
// (qmax, B), tl/tr (tmax, B), scal (16, B), out (32, B); eh is scratch of
// 2 * (qmax + 1) * B int32.
#include "banded_extend.h"

extern "C" void bwamem_banded_fused_host(
    const int8_t* ql, const int8_t* tl, const int8_t* qr, const int8_t* tr,
    const int32_t* scal, const int32_t* prm, int32_t* out, int32_t* eh,
    int64_t B, int64_t eh_rows) {
  const BwPrm p = {prm[0], prm[1], prm[2], prm[3], prm[4], prm[5], prm[6]};
  for (int64_t lane = 0; lane < B; ++lane)
    bw_fused_lane(ql + lane, qr + lane, B, tl + lane, tr + lane, B,
                  scal + lane, out + lane, B, p, eh + lane,
                  eh + eh_rows * B + lane, B);
}
