"""Gaussian image pyramid with cv::pyrDown parity.

The reference builds template and source pyramids with cv::buildPyramid
(MatchTool/MatchToolDlg.cpp:459, :788-796), i.e. repeated pyrDown:
5-tap [1,4,6,4,1]/16 separable blur, BORDER_REFLECT_101, stride-2
subsample, output size ((n+1)/2), and for u8 inputs fixed-point rounding
((sum + 128) >> 8 of the integer-weighted 2D sum).

Device form: the 25-tap stride-2 stencil as shifted strided slices, which
XLA fuses into one memory-bound kernel. The integer 2D sum is at most
255*256 = 65280 < 2^24, so every f32 partial sum is exact and no matmul
precision (TF32 on the GPU) is involved.
"""

from __future__ import annotations

from typing import List

import jax
import jax.numpy as jnp
import numpy as np

_KERNEL_1D = np.array([1.0, 4.0, 6.0, 4.0, 1.0], dtype=np.float32)
_KERNEL_2D = np.outer(_KERNEL_1D, _KERNEL_1D)  # sums to 256


def _reflect101_pad2(x: jnp.ndarray) -> jnp.ndarray:
    """Pad 2 px on each side with BORDER_REFLECT_101 (gfedcb|abcdefgh|gfedcb)."""
    return jnp.pad(x, ((2, 2), (2, 2)), mode="reflect")


def pyr_down(img: jnp.ndarray) -> jnp.ndarray:
    """One cv::pyrDown step on a 2D u8/f32 image; returns u8-valued f32.

    Output shape ((h+1)//2, (w+1)//2); values are exactly cv2.pyrDown's
    u8 results (tests/test_pyramid.py; on the GPU, chip_smoke.py checks
    the full 7-level pyramid of a 3036x4024 frame bit for bit). On the
    H100 this stencil beat the former banded-matmul form (two f32
    matmuls at HIGHEST) about 4x (PERF.md)."""
    h, w = img.shape
    oh, ow = (h + 1) // 2, (w + 1) // 2
    x = _reflect101_pad2(img.astype(jnp.float32))
    out = jnp.zeros((oh, ow), jnp.float32)
    for i in range(5):
        for j in range(5):
            wgt = float(_KERNEL_2D[i, j])
            sl = jax.lax.slice(x, (i, j), (i + 2 * oh - 1, j + 2 * ow - 1),
                               (2, 2))
            out = out + wgt * sl
    # Fixed-point cast: (sum + 128) >> 8 on the integer sum.
    return jnp.floor((out + 128.0) / 256.0)


def build_pyramid(img: jnp.ndarray, levels: int) -> List[jnp.ndarray]:
    """cv::buildPyramid: returns [level0, ..., level_levels] (levels+1 images),
    all as u8-valued f32 arrays."""
    out = [img.astype(jnp.float32)]
    for _ in range(levels):
        out.append(pyr_down(out[-1]))
    return out
