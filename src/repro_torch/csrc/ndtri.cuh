// torch.special.ndtri for float32 as PyTorch computes it on CUDA, for the
// lognormal repair quantile of the CTMC chunk kernel (ctmc_chunk.cu).
//
// PyTorch's CUDA ndtri is a jiterator kernel (ATen/native/cuda/Math.cuh,
// ndtri_string: the Cephes ndtri, 3-clause BSD licence, evaluated in the
// input's float type with float32 coefficients), compiled at run time by
// NVRTC, which contracts each multiply-add into an FMA.  This copy is
// built into a library with -fmad=false, so it writes those contractions
// out as fmaf: Horner's step result * x + A[i], and y + y * q.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace ndtri_detail {

// Horner's rule over len coefficients, highest power first.
__device__ __forceinline__ float polevl(float x, const float* A, int len) {
  float result = 0.0f;
  for (int i = 0; i < len; ++i) result = fmaf(result, x, A[i]);
  return result;
}

__device__ const float kP0[5] = {
    -5.99633501014107895267E1f, 9.80010754185999661536E1f,
    -5.66762857469070293439E1f, 1.39312609387279679503E1f,
    -1.23916583867381258016E0f};
__device__ const float kQ0[9] = {
    1.00000000000000000000E0f, 1.95448858338141759834E0f,
    4.67627912898881538453E0f, 8.63602421390890590575E1f,
    -2.25462687854119370527E2f, 2.00260212380060660359E2f,
    -8.20372256168333339912E1f, 1.59056225126211695515E1f,
    -1.18331621121330003142E0f};
__device__ const float kP1[9] = {
    4.05544892305962419923E0f, 3.15251094599893866154E1f,
    5.71628192246421288162E1f, 4.40805073893200834700E1f,
    1.46849561928858024014E1f, 2.18663306850790267539E0f,
    -1.40256079171354495875E-1f, -3.50424626827848203418E-2f,
    -8.57456785154685413611E-4f};
__device__ const float kQ1[9] = {
    1.00000000000000000000E0f, 1.57799883256466749731E1f,
    4.53907635128879210584E1f, 4.13172038254672030440E1f,
    1.50425385692907503408E1f, 2.50464946208309415979E0f,
    -1.42182922854787788574E-1f, -3.80806407691578277194E-2f,
    -9.33259480895457427372E-4f};
__device__ const float kP2[9] = {
    3.23774891776946035970E0f, 6.91522889068984211695E0f,
    3.93881025292474443415E0f, 1.33303460815807542389E0f,
    2.01485389549179081538E-1f, 1.23716634817820021358E-2f,
    3.01581553508235416007E-4f, 2.65806974686737550832E-6f,
    6.23974539184983293730E-9f};
__device__ const float kQ2[9] = {
    1.00000000000000000000E0f, 6.02427039364742014255E0f,
    3.67983563856160859403E0f, 1.37702099489081330271E0f,
    2.16236993594496635890E-1f, 1.34204006088543189037E-2f,
    3.28014464682127739104E-4f, 2.89247864745380683936E-6f,
    6.79019408009981274425E-9f};

}  // namespace ndtri_detail

// The x with Phi(x) = y0 for the standard normal CDF Phi.
__device__ __forceinline__ float ndtri(float y0) {
  using namespace ndtri_detail;
  constexpr float kExpM2 = 0.13533528323661269189f;  // exp(-2)
  if (y0 == 0.0f) return -INFINITY;
  if (y0 == 1.0f) return INFINITY;
  if (y0 < 0.0f || y0 > 1.0f) return NAN;
  bool code = true;
  float y = y0;
  if (y > 1.0f - kExpM2) {
    y = 1.0f - y;
    code = false;
  }
  if (y > kExpM2) {
    // 0 <= |y - 0.5| <= 3/8
    constexpr float kS2Pi = 2.50662827463100050242E0f;  // sqrt(2 pi)
    y = y - 0.5f;
    const float y2 = y * y;
    const float x = fmaf(y, y2 * polevl(y2, kP0, 5) / polevl(y2, kQ0, 9), y);
    return x * kS2Pi;
  }
  const float x = sqrtf(-2.0f * logf(y));
  const float x0 = x - logf(x) / x;
  const float z = 1.0f / x;
  const float x1 = x < 8.0f
                       ? z * polevl(z, kP1, 9) / polevl(z, kQ1, 9)
                       : z * polevl(z, kP2, 9) / polevl(z, kQ2, 9);
  const float r = x0 - x1;
  return code ? -r : r;
}
