// Native mel-spectrogram featurization for the host data loader.
//
// A copy of convofusion_tpu/native/melspec.cc.  It computes the hot part of
// convofusion_tpu_torch/data/audio.py::melspectrogram —
// zero-padded centered framing, periodic Hann window, radix-2 real FFT,
// power spectrum, mel filterbank projection.  All internals run in double
// precision (matching numpy's float64 rfft upcast), so the float32 output
// agrees with the numpy implementation to output-rounding error; numpy
// itself replicates librosa 0.10 defaults (reference dataset.py:506-520).
//
// The BEAT corpus is tens of hours of 16 kHz audio featurized at dataset
// construction time (dataset.py:183,284); this kernel removes the python
// framing/FFT cost from that path.  OpenMP parallelizes over frames.
//
// Build: g++ -O3 -shared -fPIC -fopenmp melspec.cc -o libmelspec.so
// (see convofusion_tpu_torch/native/__init__.py — built on first use into
// convofusion_tpu_torch/_build/, ctypes ABI).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

#if defined(_OPENMP)
#include <omp.h>
#endif

namespace {

constexpr double kPi = 3.14159265358979323846;

// iterative radix-2 complex FFT, in place; n must be a power of two
void fft_inplace(double* re, double* im, int n, const double* cos_tab,
                 const double* sin_tab) {
  // bit-reversal permutation
  for (int i = 1, j = 0; i < n; ++i) {
    int bit = n >> 1;
    for (; j & bit; bit >>= 1) j ^= bit;
    j ^= bit;
    if (i < j) {
      std::swap(re[i], re[j]);
      std::swap(im[i], im[j]);
    }
  }
  for (int len = 2; len <= n; len <<= 1) {
    const int step = n / len;
    for (int i = 0; i < n; i += len) {
      for (int k = 0; k < len / 2; ++k) {
        const double wr = cos_tab[k * step];
        const double wi = sin_tab[k * step];
        const int a = i + k, b = i + k + len / 2;
        const double ur = re[a], ui = im[a];
        const double vr = re[b] * wr - im[b] * wi;
        const double vi = re[b] * wi + im[b] * wr;
        re[a] = ur + vr;
        im[a] = ui + vi;
        re[b] = ur - vr;
        im[b] = ui - vi;
      }
    }
  }
}

}  // namespace

extern "C" {

// y:   (n,) float32 signal
// fb:  (n_mels, n_bins) float32 mel filterbank, n_bins = n_fft/2 + 1
// out: (n_frames, n_mels) float32 power-mel, n_frames = 1 + n_padded/hop
//      with n_padded = n + 2*(n_fft/2) - n_fft (caller computes, matching
//      stft_power)
// returns 0 on success, nonzero on invalid arguments
int melspec_power(const float* y, int64_t n, int n_fft, int hop,
                  int n_mels, const float* fb, float* out,
                  int64_t n_frames) {
  if (n_fft <= 0 || (n_fft & (n_fft - 1)) != 0) return 1;  // power of two
  const int pad = n_fft / 2;
  const int n_bins = n_fft / 2 + 1;

  // window + twiddle tables (shared across frames), double precision
  std::vector<double> window(n_fft), cos_tab(n_fft / 2), sin_tab(n_fft / 2);
  for (int i = 0; i < n_fft; ++i)
    window[i] = 0.5 - 0.5 * std::cos(2.0 * kPi * i / n_fft);
  for (int i = 0; i < n_fft / 2; ++i) {
    cos_tab[i] = std::cos(-2.0 * kPi * i / n_fft);
    sin_tab[i] = std::sin(-2.0 * kPi * i / n_fft);
  }

#if defined(_OPENMP)
#pragma omp parallel
#endif
  {
    std::vector<double> re(n_fft), im(n_fft), power(n_bins);
#if defined(_OPENMP)
#pragma omp for schedule(static)
#endif
    for (int64_t f = 0; f < n_frames; ++f) {
      const int64_t start = f * hop - pad;  // in unpadded coordinates
      for (int i = 0; i < n_fft; ++i) {
        const int64_t src = start + i;
        const double v = (src >= 0 && src < n)
            ? static_cast<double>(y[src]) : 0.0;
        re[i] = v * window[i];
        im[i] = 0.0;
      }
      fft_inplace(re.data(), im.data(), n_fft, cos_tab.data(),
                  sin_tab.data());
      for (int b = 0; b < n_bins; ++b)
        power[b] = re[b] * re[b] + im[b] * im[b];
      float* row = out + f * n_mels;
      for (int m = 0; m < n_mels; ++m) {
        const float* w = fb + static_cast<int64_t>(m) * n_bins;
        double acc = 0.0;
        for (int b = 0; b < n_bins; ++b)
          acc += power[b] * static_cast<double>(w[b]);
        row[m] = static_cast<float>(acc);
      }
    }
  }
  return 0;
}

}  // extern "C"
