"""Batched affine warps as one bilinear gather.

The reference warps the source once per angle with cv::warpAffine
(INTER_LINEAR + BORDER_CONSTANT; MatchTool/MatchToolDlg.cpp:856 for the
top-layer canvas, :1327 for refinement ROIs). Here the per-angle loop
becomes a single batched gather over an [A, Ho, Wo] coordinate grid with
static shapes — per-angle canvas-size differences are handled by masking
downstream, not by dynamic shapes.

Coordinates use the *inverse* map (dst -> src), which is what warpAffine
computes internally from the forward matrix.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp


def warp_affine_batch(
    src: jnp.ndarray,            # [H, W] f32
    inv_mats: jnp.ndarray,       # [A, 2, 3] f32 (dst->src affine)
    out_hw: Tuple[int, int],
    border_value,                # scalar or [A]
    quantize: bool = True,
    fixed_point_frac: bool = False,
) -> jnp.ndarray:
    """Bilinear-sample `src` at A affine grids -> [A, Ho, Wo] f32.

    Four per-tap gathers, the blend and the rounding, which XLA fuses into
    one memory-bound kernel on the GPU. On the H100 this beat a one-gather
    (2,2)-slice form and a hand-written Pallas/Triton kernel (PERF.md).

    `quantize` rounds the result to integers, emulating the reference's u8
    warped mats. fixed_point_frac emulates OpenCV <= 4.x's 10-bit fixed-point
    coordinate path (AB_BITS=10/INTER_BITS=5); OpenCV 5 — and our default —
    uses exact float coordinates.
    """
    H, W = src.shape
    Ho, Wo = out_hw
    xs = jax.lax.broadcasted_iota(jnp.float32, (Ho, Wo), 1)
    ys = jax.lax.broadcasted_iota(jnp.float32, (Ho, Wo), 0)

    a = inv_mats[:, 0, 0][:, None, None]
    b = inv_mats[:, 0, 1][:, None, None]
    tx = inv_mats[:, 0, 2][:, None, None]
    c = inv_mats[:, 1, 0][:, None, None]
    d = inv_mats[:, 1, 1][:, None, None]
    ty = inv_mats[:, 1, 2][:, None, None]

    if fixed_point_frac:
        # Emulate warpAffine's fixed-point coordinate path exactly:
        # adelta[x] = rint(M00*x*1024), per-row base = rint((M01*y+M02)*1024),
        # X = (sum + 16) >> 5 gives a 5-bit-fraction coordinate
        # (AB_BITS=10, INTER_BITS=5, round_delta=AB_SCALE/TAB_SIZE/2=16).
        xf = (jnp.round(a * xs * 1024.0)
              + jnp.round((b * ys + tx) * 1024.0) + 16.0)
        yf = (jnp.round(c * xs * 1024.0)
              + jnp.round((d * ys + ty) * 1024.0) + 16.0)
        x32 = jnp.floor(xf / 32.0)
        y32 = jnp.floor(yf / 32.0)
        x0 = jnp.floor(x32 / 32.0)
        y0 = jnp.floor(y32 / 32.0)
        ax = (x32 - x0 * 32.0) / 32.0
        ay = (y32 - y0 * 32.0) / 32.0
        x0 = x0.astype(jnp.int32)
        y0 = y0.astype(jnp.int32)
    else:
        fx = a * xs + b * ys + tx          # [A, Ho, Wo]
        fy = c * xs + d * ys + ty
        x0f = jnp.floor(fx)
        y0f = jnp.floor(fy)
        ax = fx - x0f
        ay = fy - y0f
        x0 = x0f.astype(jnp.int32)
        y0 = y0f.astype(jnp.int32)

    border = jnp.asarray(border_value, dtype=jnp.float32)
    if border.ndim == 1:
        border = border[:, None, None]

    def tap(yi, xi):
        inb = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        xi_c = jnp.clip(xi, 0, W - 1)
        yi_c = jnp.clip(yi, 0, H - 1)
        v = src[yi_c, xi_c]
        return jnp.where(inb, v, border)

    v00 = tap(y0, x0)
    v01 = tap(y0, x0 + 1)
    v10 = tap(y0 + 1, x0)
    v11 = tap(y0 + 1, x0 + 1)

    out = ((1 - ax) * (1 - ay) * v00 + ax * (1 - ay) * v01
           + (1 - ax) * ay * v10 + ax * ay * v11)
    if quantize:
        out = jnp.round(out)
    return out


def rotate_pt_jnp(pt: jnp.ndarray, org, angle_rad) -> jnp.ndarray:
    """Traced version of utils.geometry.rotate_pt (ptRotatePt2f parity,
    MatchToolDlg.cpp:1469-1480): rotate pt [..., 2] about org by angle_rad
    (broadcastable over leading dims)."""
    org = jnp.asarray(org, dtype=jnp.float32)
    c = jnp.cos(angle_rad)
    s = jnp.sin(angle_rad)
    dx = pt[..., 0] - org[..., 0]
    dy = pt[..., 1] - org[..., 1]
    x = org[..., 0] + dx * c + dy * s
    y = org[..., 1] - dx * s + dy * c
    return jnp.stack([x, y], axis=-1)


def make_rotation_invmaps(
    center_xy, angles_deg: jnp.ndarray, shift_xy: jnp.ndarray
) -> jnp.ndarray:
    """Inverse (dst->src) affines [N, 2, 3] for forward maps
    'rotate about center by angle (getRotationMatrix2D convention), then
    translate by shift' — built from traced angles/shifts.

    Inverse: p = rotate_pt(p' - shift, center, -angle_rad).
    """
    cx, cy = center_xy
    a = angles_deg * jnp.float32(jnp.pi / 180.0)
    ca, sa = jnp.cos(a), jnp.sin(a)
    sx = shift_xy[..., 0]
    sy = shift_xy[..., 1]
    # x = ca*px' - sa*py' + (cx - ca*(sx+cx) + sa*(sy+cy))
    # y = sa*px' + ca*py' + (cy - sa*(sx+cx) - ca*(sy+cy))
    tx = cx - ca * (sx + cx) + sa * (sy + cy)
    ty = cy - sa * (sx + cx) - ca * (sy + cy)
    row0 = jnp.stack([ca, -sa, tx], axis=-1)
    row1 = jnp.stack([sa, ca, ty], axis=-1)
    return jnp.stack([row0, row1], axis=-2)
