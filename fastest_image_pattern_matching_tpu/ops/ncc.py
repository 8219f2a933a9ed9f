"""Fused normalized cross-correlation (TM_CCOEFF_NORMED) score maps.

Reference pipeline per rotated canvas: raw TM_CCORR (cv::matchTemplate or
the SIMD u8 dot path, MatchTool/MatchToolDlg.cpp:1275-1311) followed by
CCOEFF_Denominator (integral-image window stats + numeric guards,
MatchToolDlg.cpp:1329-1400).

Batched formulation (one fused op over all canvases):
  Let Sc = S - 128 and Tc = T - 128 (both in [-128, 127], exact in bf16),
  T_bar = mean(T). With T' = T - T_bar (zero-mean template):

      num   = sum_w S*T' = ccorr_c + (128 - T_bar) * s1c
      where ccorr_c = corr(Sc, Tc)  <- the one contraction that matters
            s1c     = window sums of Sc (separable reduce_window, exact)
            s2c     = window sums of Sc^2
      diff2 = s2c - s1c^2/area      (= sum_w (S - S_bar)^2, shift-invariant)
      t     = sqrt(diff2) * templNorm, with the reference's rounding-error
              cutoff and the 1.125 clamp band (MatchToolDlg.cpp:1384-1395).

This centering keeps every matmul input integer-valued (exact in bf16) and
makes the numerator numerically benign — no large-magnitude cancellation
like raw CCORR - mean*sum.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

FLT_EPSILON = np.float32(1.1920929e-07)


def window_sums(x: jnp.ndarray, hw: Tuple[int, int]) -> jnp.ndarray:
    """Valid-mode sliding-window sums over the last two dims via two
    separable reduce_windows: [..., H, W] -> [..., H-h+1, W-w+1]."""
    h, w = hw
    nb = x.ndim - 2
    dims_h = (1,) * nb + (h, 1)
    dims_w = (1,) * nb + (1, w)
    strides = (1,) * x.ndim
    y = jax.lax.reduce_window(x, 0.0, jax.lax.add, dims_h, strides, "VALID")
    return jax.lax.reduce_window(y, 0.0, jax.lax.add, dims_w, strides, "VALID")


def _precision(compute_dtype: str):
    """f32 correlations must not run in TF32 (an 11-bit significand cannot
    hold centered u8 products summed over a window); bf16 operands are
    exact by construction."""
    return jax.lax.Precision.HIGHEST if compute_dtype == "f32" else None


def ccorr_conv(
    canvases_c: jnp.ndarray,   # [B, H, W] f32, already centered (S - 128)
    templ_c: jnp.ndarray,      # [h, w] f32, centered (T - 128)
    compute_dtype: str = "bf16",
) -> jnp.ndarray:
    """Raw centered cross-correlation conv(Sc, Tc) -> [B, Ho, Wo] f32."""
    dt = jnp.float32 if compute_dtype == "f32" else jnp.bfloat16
    out = jax.lax.conv_general_dilated(
        canvases_c.astype(dt)[:, None], templ_c.astype(dt)[None, None],
        window_strides=(1, 1), padding="VALID",
        dimension_numbers=("NCHW", "OIHW", "NCHW"),
        precision=_precision(compute_dtype),
        preferred_element_type=jnp.float32,
    )
    return out[:, 0]


def ccorr_shiftmm(
    canvases_c: jnp.ndarray,   # [B, H, W] f32, centered
    templ_c: jnp.ndarray,      # [h, w] f32, centered
    compute_dtype: str = "bf16",
) -> jnp.ndarray:
    """Centered cross-correlation for SMALL output grids as ONE dense
    matmul: score[b, s] = <roi[b], template shifted by s>.

    A valid conv whose kernel nearly fills the input is a matmul with a
    handful of output columns; materializing all Ho*Wo shifted copies of
    the template gives one dense [B, H*W] x [H*W, Ho*Wo] product instead
    (the descent's 7x7 searches; faster than conv and FFT there on the
    H100, PERF.md). Shifted copies are exact; bf16 on u8-centered values
    with f32 accumulation is exact (see module doc).
    """
    B, H, W = canvases_c.shape
    h, w = templ_c.shape
    Ho, Wo = H - h + 1, W - w + 1
    dt = jnp.float32 if compute_dtype == "f32" else jnp.bfloat16
    tc = templ_c.astype(dt)
    rc = canvases_c.astype(dt)
    shifts = [jnp.pad(tc, ((dy, Ho - 1 - dy), (dx, Wo - 1 - dx)))
              for dy in range(Ho) for dx in range(Wo)]
    tsh = jnp.stack(shifts)  # [Ho*Wo, H, W]
    out = jax.lax.dot_general(
        rc, tsh, (((1, 2), (1, 2)), ((), ())),
        precision=_precision(compute_dtype),
        preferred_element_type=jnp.float32)  # [B, Ho*Wo]
    return out.reshape(B, Ho, Wo)


# "auto" picks shiftmm for output grids of at most _SHIFTMM_MAX_OUT
# positions over templates of more than _SHIFTMM_MIN_TEMPLATE pixels: there
# one dense matmul beats cuDNN by up to 2x on the H100; over smaller
# templates it is not faster than the convolution (PERF.md, auto table).
_SHIFTMM_MAX_OUT = 512
_SHIFTMM_MIN_TEMPLATE = 4096
# Direct-MAC count (B*Ho*Wo*h*w) up to which "auto" keeps the exact
# convolution: below it cuDNN's time is launch-bound and level with FFT
# on the H100; above it cuFFT wins by 2-12x (PERF.md, auto table).
_CONV_MAX_MACS = 2 ** 25


def choose_method(B: int, H: int, W: int, h: int, w: int) -> str:
    """The correlation form "auto" picks for B canvases of H x W against
    an h x w template, from the shapes alone (PERF.md, auto table):
    shiftmm for small output grids over big templates (the descent's 7x7
    searches at the lower levels), the exact convolution while it is
    launch-bound, FFT beyond."""
    Ho, Wo = H - h + 1, W - w + 1
    if Ho * Wo <= _SHIFTMM_MAX_OUT and h * w > _SHIFTMM_MIN_TEMPLATE:
        return "shiftmm"
    if B * Ho * Wo * h * w <= _CONV_MAX_MACS:
        return "conv"
    return "fft"


def ccorr_fft(
    canvases_c: jnp.ndarray,   # [B, H, W] f32, centered
    templ_c: jnp.ndarray,      # [h, w] f32, centered
) -> jnp.ndarray:
    """Raw centered cross-correlation via FFT -> [B, Ho, Wo] f32.

    Valid-mode correlation falls out of a circular FFT of the *source*
    size: wraparound only contaminates outputs beyond (H-h+1, W-w+1),
    which are sliced away. Not bit-exact (~1e-7 relative); the fastest
    form on the H100 once the direct correlation leaves the launch-bound
    regime (PERF.md).
    """
    B, H, W = canvases_c.shape
    h, w = templ_c.shape
    fs = jnp.fft.rfft2(canvases_c, s=(H, W))
    ft = jnp.fft.rfft2(templ_c, s=(H, W))
    corr = jnp.fft.irfft2(fs * jnp.conj(ft)[None], s=(H, W))
    return corr[:, : H - h + 1, : W - w + 1].astype(jnp.float32)


def ncc_score_map(
    canvases: jnp.ndarray,      # [B, H, W] f32 (u8-valued)
    templ: jnp.ndarray,         # [h, w] f32 (u8-valued)
    templ_mean: float,          # host-precomputed f64 scalar (meanStdDev)
    templ_norm: float,          # sigma * sqrt(area)
    inv_area: float,
    result_equal1: bool,
    compute_dtype: str = "bf16",
    method: str = "auto",
) -> jnp.ndarray:
    """Fused TM_CCORR + CCOEFF_Denominator -> [B, Ho, Wo] f32 scores.

    Matches cv::matchTemplate(TM_CCOEFF_NORMED) semantics including the
    flat-template all-ones shortcut (MatchToolDlg.cpp:1331-1335) and the
    epsilon/1.125 guards (:1384-1395).

    method:
      "conv"    — lax.conv (cuDNN implicit GEMM on the GPU); exact.
      "shiftmm" — one dense matmul against all Ho*Wo shifted template
                  copies; the pyramid-descent regime (tiny output grid
                  over a big template); exact.
      "fft"     — frequency-domain correlation (not bit-exact, ~1e-7
                  relative).
      "auto"    — choose_method: shiftmm when Ho*Wo <= 512 and
                  h*w > 4096; conv while B*Ho*Wo*h*w <= 2^25; fft beyond.
    """
    h, w = templ.shape
    B, H, W = canvases.shape
    if result_equal1:
        return jnp.ones((B, H - h + 1, W - w + 1), dtype=jnp.float32)

    sc = canvases - 128.0
    tc = templ - 128.0

    if method == "auto":
        method = choose_method(B, H, W, h, w)
    if method == "fft":
        ccorr_c = ccorr_fft(sc, tc)
    elif method == "shiftmm":
        ccorr_c = ccorr_shiftmm(sc, tc, compute_dtype)
    elif method == "conv":
        ccorr_c = ccorr_conv(sc, tc, compute_dtype)
    else:
        # A typo must fail loudly, not silently take the conv path.
        raise ValueError(f"unknown correlation method {method!r} "
                         "(expected auto|conv|shiftmm|fft)")
    return scores_from_ccorr(sc, ccorr_c, (h, w), templ_mean, templ_norm,
                             inv_area)


def scores_from_ccorr(sc, ccorr_c, hw, templ_mean, templ_norm, inv_area):
    """CCOEFF_Denominator: the centered correlation ccorr_c of the centered
    canvases sc with the centered template -> [B, Ho, Wo] f32 scores."""
    h, w = hw
    area = float(h * w)
    s1c = window_sums(sc, (h, w))
    s2c = window_sums(sc * sc, (h, w))

    num = ccorr_c + jnp.float32(128.0 - templ_mean) * s1c
    wnd_sum2 = s2c + 256.0 * s1c + 16384.0 * area
    diff2 = jnp.maximum(s2c - s1c * s1c * jnp.float32(inv_area), 0.0)

    cutoff = jnp.minimum(jnp.float32(0.5), 10.0 * FLT_EPSILON * wnd_sum2)
    t = jnp.where(diff2 <= cutoff, 0.0, jnp.sqrt(diff2) * jnp.float32(templ_norm))

    num_abs = jnp.abs(num)
    safe_t = jnp.maximum(t, jnp.float32(1e-30))
    score = jnp.where(
        num_abs < t, num / safe_t,
        jnp.where(num_abs < t * 1.125, jnp.sign(num), 0.0))
    return score.astype(jnp.float32)
