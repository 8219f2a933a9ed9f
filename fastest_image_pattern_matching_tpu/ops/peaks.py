"""Multi-target peak extraction (GetNextMaxLoc semantics, batched).

The reference iteratively takes the global max of a score map, then paints a
suppression rectangle of size 2W(1-overlap) x 2H(1-overlap) centred on it
with -1 and repeats (MatchTool/MatchToolDlg.cpp:1558-1582), optionally
accelerated with the s_BlockMax block cache (:1583-1596, MatchToolDlg.h:89-214).

Two exact implementations, same results:

* Batched masked-argmax (`_extract_peaks_masked`): each fori_loop round does
  one [A, H*W] argmax plus a masked store over the full maps. Right for the
  top-layer angle sweep, where maps are small and the angle batch amortizes
  the rounds. Identical to the reference's greedy order (row-major first-max
  tie-break, matching cv::minMaxLoc).

* Tiled BlockMax (`_extract_peaks_tiled`): the s_BlockMax idea in a
  fixed-shape form for the single-angle many-target regime (tol=0 over a large
  full-resolution map, README.md:23-29). The map is tiled into
  suppression-rect-sized blocks; a per-tile (max, first-flat-index) cache is
  maintained, each round reduces over the ~10^3 tile maxes instead of the
  ~10^7 map and re-scans only the <=2x2 tiles intersecting the suppression
  rectangle via dynamic_slice/update. Exact row-major first-max tie-break is
  preserved by carrying the minimal flat index per tile max: the global pick
  is min(flat_idx) over tiles attaining max(tile_max).

The reference stops extracting once a peak drops below the layer threshold;
we extract a fixed K peaks and mark the below-threshold tail invalid, which
yields the same valid set (everything after the break would be below
threshold as well).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp


def _ceil_to(v: int, m: int) -> int:
    return (v + m - 1) // m * m


def _extract_peaks_tiled(
    smap: jnp.ndarray,          # [Hs, Ws] f32 (invalid regions pre-masked to -1)
    k: int,
    sw: int, sh: int,           # suppression rect size (pre-truncated ints)
    off_x: float, off_y: float,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Single-map tiled greedy extraction; returns (vals [k], locs [k, 2])."""
    Hs, Ws = smap.shape
    # Tile shape: VPU-aligned (8 sublanes x 128 lanes) and >= the rect, so a
    # rectangle touches at most 2 tiles per axis.
    TH = _ceil_to(max(sh, 8), 8)
    TW = _ceil_to(max(sw, 128), 128)
    WY = (sh - 1) // TH + 2 if sh > 0 else 1
    WX = (sw - 1) // TW + 2 if sw > 0 else 1
    nTy = max(-(-Hs // TH), WY)
    nTx = max(-(-Ws // TW), WX)
    Hp, Wp = nTy * TH, nTx * TW
    # Padding at -2 never wins against real scores (>= -1, the mask fill).
    map_p = jnp.pad(smap, ((0, Hp - Hs), (0, Wp - Ws)), constant_values=-2.0)
    BIG = jnp.int32(Hp * Wp)

    ty_i = jax.lax.broadcasted_iota(jnp.int32, (nTy, nTx), 0)
    tx_i = jax.lax.broadcasted_iota(jnp.int32, (nTy, nTx), 1)

    def tile_stats(tiles, ty0, tx0):
        """tiles [wy, wx, TH*TW] -> (max [wy,wx], first global flat idx)."""
        tmax = jnp.max(tiles, axis=-1)
        loc = jnp.argmax(tiles, axis=-1).astype(jnp.int32)  # first max wins
        wy, wx = tiles.shape[0], tiles.shape[1]
        tys = ty0 + jax.lax.broadcasted_iota(jnp.int32, (wy, wx), 0)
        txs = tx0 + jax.lax.broadcasted_iota(jnp.int32, (wy, wx), 1)
        gidx = (tys * TH + loc // TW) * Wp + txs * TW + loc % TW
        return tmax, gidx

    tiles0 = map_p.reshape(nTy, TH, nTx, TW).transpose(0, 2, 1, 3)
    tmax0, targ0 = tile_stats(tiles0.reshape(nTy, nTx, TH * TW), 0, 0)

    def body(i, carry):
        m_p, tmax, targ, vals, locs = carry
        v = jnp.max(tmax)
        gidx = jnp.min(jnp.where(tmax == v, targ, BIG))
        y = gidx // Wp
        x = gidx % Wp
        vals = vals.at[i].set(v)
        locs = locs.at[i, 0].set(x)
        locs = locs.at[i, 1].set(y)

        x0 = jnp.trunc(x.astype(jnp.float32) - off_x).astype(jnp.int32)
        y0 = jnp.trunc(y.astype(jnp.float32) - off_y).astype(jnp.int32)
        sy = jnp.clip(y0 // TH, 0, nTy - WY)
        sx = jnp.clip(x0 // TW, 0, nTx - WX)
        region = jax.lax.dynamic_slice(
            m_p, (sy * TH, sx * TW), (WY * TH, WX * TW))
        gys = sy * TH + jax.lax.iota(jnp.int32, WY * TH)
        gxs = sx * TW + jax.lax.iota(jnp.int32, WX * TW)
        in_rect = (((gys >= y0) & (gys <= y0 + sh - 1))[:, None]
                   & ((gxs >= x0) & (gxs <= x0 + sw - 1))[None, :])
        region = jnp.where(in_rect, jnp.float32(-1.0), region)
        m_p = jax.lax.dynamic_update_slice(m_p, region, (sy * TH, sx * TW))

        wtiles = region.reshape(WY, TH, WX, TW).transpose(0, 2, 1, 3)
        wmax, wtarg = tile_stats(wtiles.reshape(WY, WX, TH * TW), sy, sx)
        tmax = jax.lax.dynamic_update_slice(tmax, wmax, (sy, sx))
        targ = jax.lax.dynamic_update_slice(targ, wtarg, (sy, sx))
        return m_p, tmax, targ, vals, locs

    vals0 = jnp.full((k,), -1.0, dtype=jnp.float32)
    locs0 = jnp.zeros((k, 2), dtype=jnp.int32)
    _, _, _, vals, locs = jax.lax.fori_loop(
        0, k, body, (map_p, tmax0, targ0, vals0, locs0))
    return vals, locs


def extract_peaks(
    scores: jnp.ndarray,        # [A, Hs, Ws] f32 (invalid regions pre-masked to -1)
    k: int,                     # peaks per map = max_pos + MATCH_CANDIDATE_NUM
    templ_wh: Tuple[int, int],  # template (w, h) at this layer
    max_overlap: float,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Greedy masked top-K per score map.

    Returns (vals [A, k] f32, locs [A, k, 2] i32 as (x, y)).
    Threshold filtering is left to the caller (vals keep raw peak scores).
    """
    A, Hs, Ws = scores.shape
    tw, th = templ_wh
    # Suppression rect: x in [x0, x0 + ws - 1], cv::rectangle(Rect) fills the
    # inclusive pixel range; int casts truncate toward zero like C.
    sw = int(2 * tw * (1 - max_overlap))
    sh = int(2 * th * (1 - max_overlap))
    off_x = tw * (1.0 - max_overlap)
    off_y = th * (1.0 - max_overlap)

    # Single-angle large-map many-target regime -> tiled BlockMax (exact;
    # per-round cost O(tiles + rect) instead of O(H*W)). The reference's
    # enable condition is a perf heuristic (srcArea/templArea > 500 &&
    # maxPos > 10, MatchToolDlg.cpp:842); ours differs only in cost.
    if A == 1 and Hs * Ws >= 65536 and sw > 0 and sh > 0:
        vals, locs = _extract_peaks_tiled(scores[0], k, sw, sh, off_x, off_y)
        return vals[None], locs[None]

    xs = jax.lax.broadcasted_iota(jnp.int32, (Hs, Ws), 1)
    ys = jax.lax.broadcasted_iota(jnp.int32, (Hs, Ws), 0)

    def body(i, carry):
        maps, vals, locs = carry
        flat_idx = jnp.argmax(maps.reshape(A, Hs * Ws), axis=1)  # first max wins
        y = (flat_idx // Ws).astype(jnp.int32)
        x = (flat_idx % Ws).astype(jnp.int32)
        v = maps.reshape(A, Hs * Ws)[jnp.arange(A), flat_idx]
        vals = vals.at[:, i].set(v)
        locs = locs.at[:, i, 0].set(x)
        locs = locs.at[:, i, 1].set(y)
        x0 = jnp.trunc(x.astype(jnp.float32) - off_x).astype(jnp.int32)
        y0 = jnp.trunc(y.astype(jnp.float32) - off_y).astype(jnp.int32)
        in_rect = ((xs[None] >= x0[:, None, None])
                   & (xs[None] <= (x0 + sw - 1)[:, None, None])
                   & (ys[None] >= y0[:, None, None])
                   & (ys[None] <= (y0 + sh - 1)[:, None, None]))
        maps = jnp.where(in_rect, jnp.float32(-1.0), maps)
        return maps, vals, locs

    vals0 = jnp.full((A, k), -1.0, dtype=jnp.float32)
    locs0 = jnp.zeros((A, k, 2), dtype=jnp.int32)
    _, vals, locs = jax.lax.fori_loop(0, k, body, (scores, vals0, locs0))
    return vals, locs
