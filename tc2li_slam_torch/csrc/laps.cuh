// Clock laps of a kernel's phases, for a phase split (tools/vi_kernels.py).
// A source that holds TC2LI_LAP_START and TC2LI_LAP(k) includes this header
// under -DTC2LI_LAPS (build.variant), after it defines TC2LI_LAP_TAG, and
// defines both macros empty otherwise. Thread 0 of block 0 adds the cycles
// since its last lap to phase k's slot and counts the lap; the host reads
// the slots with tc2li_laps_read_<tag> and zeroes them with
// tc2li_laps_reset_<tag>.
#pragma once

#include <cuda_runtime.h>

#define TC2LI_LAPS_CAT_(a, b) a##b
#define TC2LI_LAPS_CAT(a, b) TC2LI_LAPS_CAT_(a, b)

namespace {
constexpr int kLapSlots = 64;
__device__ long long tc2li_laps[2 * kLapSlots];   // cycles of phase k at k, its laps at 64 + k
__shared__ long long tc2li_lap_t0;
}  // namespace

#define TC2LI_LAP_START \
  if (threadIdx.x == 0) tc2li_lap_t0 = clock64();
#define TC2LI_LAP(k)                                         \
  do {                                                       \
    if (threadIdx.x == 0 && blockIdx.x == 0) {               \
      const long long now_ = clock64();                      \
      tc2li_laps[(k)] += now_ - tc2li_lap_t0;                \
      tc2li_laps[kLapSlots + (k)] += 1;                      \
      tc2li_lap_t0 = now_;                                   \
    }                                                        \
  } while (0)

extern "C" int TC2LI_LAPS_CAT(tc2li_laps_read_, TC2LI_LAP_TAG)(long long* out) {
  return static_cast<int>(cudaMemcpyFromSymbol(out, tc2li_laps, sizeof(tc2li_laps)));
}

extern "C" int TC2LI_LAPS_CAT(tc2li_laps_reset_, TC2LI_LAP_TAG)() {
  static const long long zero[2 * kLapSlots] = {};
  return static_cast<int>(cudaMemcpyToSymbol(tc2li_laps, zero, sizeof(zero)));
}
