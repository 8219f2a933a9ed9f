"""Coarse-to-fine rotation-invariant NCC template matching — the accelerator
equivalent of the reference's Match() pipeline (MatchTool/MatchToolDlg.cpp:772-1148)
and LearnPattern (:453-491).

Architecture (vs the reference's per-angle C++ loops):
  * learn_pattern: host-side, float64 stats (tiny, once per template).
  * match: one compiled XLA program per (source shape, template shape,
    config) — pyramid build, batched top-layer angle sweep (angle loop ->
    batched warp + one batched correlation), vectorized greedy peak extraction,
    masked fixed-depth candidate descent (per-candidate loops -> vmapped
    chunked batches), batched subpixel solve, on-device rotated-rect NMS.
  * All shapes static; per-angle canvas-size variation handled by masking
    into a max-canvas, per-candidate early exits by alive masks.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import D2R, MATCH_CANDIDATE_NUM, MatchConfig, R2D, VISION_TOLERANCE
from ..types import LearnedPattern, LevelData, MatchResult
from ..utils import geometry
from ..utils.chunking import chunked_map
from ..ops.pyramid import build_pyramid, pyr_down
from ..ops.ncc import ncc_score_map
from ..ops.peaks import extract_peaks
from ..ops.nms import filter_overlaps, rotated_rect_corners
from ..ops.subpixel import subpixel_refine
from ..ops.warp import (make_rotation_invmaps, rotate_pt_jnp,
                        warp_affine_batch)

DBL_EPSILON = 2.220446049250313e-16

# One jitted program for the whole learn pyramid: eager per-level
# pyr_down costs one executable load per level per fresh process.
_pyr_jit = jax.jit(build_pyramid, static_argnums=1)


def _descend_chunk(roi_hw, templ_px: int, k_ang: int) -> int:
    """Candidate-chunk size for one descent layer. Small chunks on
    expensive layers make alive-masked chunk-skipping (the single-program
    analogue of host-side bucket compaction) save real work; cheap layers
    use bigger chunks to amortize per-step lax.map overhead. With the
    uncapped candidate set (reference parity: every top-layer peak is
    refined) most candidates are dead within a layer or two, so skipped
    chunks dominate."""
    chunk = max(1, _CHUNK_BUDGET_ELEMS // (roi_hw[0] * roi_hw[1] * k_ang * 8))
    if templ_px > 4096:
        return min(chunk, 8)
    if templ_px > 1024:
        return min(chunk, 32)
    return min(chunk, 64)

# Device-memory budget per chunked stage, in f32 elements (~512 MB live per
# stage, under 1% of an 80 GB H100; bigger chunks amortize per-step
# overheads in the chunked lax.map pipelines). Not yet tuned on the GPU.
_CHUNK_BUDGET_ELEMS = 128 * 1024 * 1024


def learn_pattern(templ: np.ndarray, min_reduce_area: int = 256,
                  roi: Optional[Tuple[int, int, int, int]] = None,
                  regions=None) -> LearnedPattern:
    """Build the template pyramid + per-level stats (LearnPattern,
    MatchToolDlg.cpp:453-491). Stats in float64 on host, pyramid via the
    same device pyr_down used for the source (bit-identical levels).

    roi: optional (x, y, w, h) sub-rectangle of `templ` to learn from (the
    UI's user-rect capability, src/MatchToolDialog.cpp:1087-1123). Match
    coordinates then refer to the ROI rectangle, not the full image.

    regions: optional iterable of [N, 2] polygon point arrays in `templ`
    image coordinates (the UI's polygon marking,
    src/MatchToolDialog.cpp:962-1030). Stored on the pattern (shifted into
    ROI coordinates when roi is given) and projected into every match's
    source frame by match() via MatchResult.project_points."""
    templ = np.asarray(templ)
    if templ.ndim == 3:
        from ..utils.imageio import ensure_gray
        templ = ensure_gray(templ)
    templ = templ.astype(np.float32)
    if roi is not None:
        x, y, w, h = (int(v) for v in roi)
        if not (0 <= x and 0 <= y and w > 0 and h > 0
                and x + w <= templ.shape[1] and y + h <= templ.shape[0]):
            raise ValueError(f"roi {roi} out of bounds for template "
                             f"{templ.shape}")
        templ = templ[y:y + h, x:x + w]
        roi = (x, y, w, h)
    region_arrs = []
    for reg in (regions or ()):
        pts = np.asarray(reg, np.float32).reshape(-1, 2)
        if pts.shape[0] < 3:
            raise ValueError("each region needs >= 3 points "
                             "(finishPolygonSelection requires 3)")
        if roi is not None:
            pts = pts - np.array([roi[0], roi[1]], np.float32)
        region_arrs.append(pts)

    top = geometry.top_layer(templ.shape, min_reduce_area)
    pyr = [np.asarray(p) for p in _pyr_jit(jnp.asarray(templ), top)]

    levels: List[LevelData] = []
    for p in pyr:
        area = p.shape[0] * p.shape[1]
        inv_area = 1.0 / float(area)
        mean = float(np.mean(p, dtype=np.float64))
        var = float(np.mean((p.astype(np.float64) - mean) ** 2))
        equal1 = var < DBL_EPSILON
        norm = np.sqrt(var) * np.sqrt(float(area))
        levels.append(LevelData(templ=p, mean=mean, norm=float(norm),
                                inv_area=inv_area, result_equal1=equal1))
    border_color = 255 if float(np.mean(pyr[0], dtype=np.float64)) < 128 else 0
    return LearnedPattern(levels=levels, border_color=border_color,
                          min_reduce_area=min_reduce_area, roi=roi,
                          regions=tuple(region_arrs))


@dataclasses.dataclass(frozen=True)
class _Plan:
    """Static match plan — everything shape-determining, host-computed."""
    src_hw: Tuple[int, int]
    templ_shapes: Tuple[Tuple[int, int], ...]
    top: int
    stop: int
    angles: Tuple[float, ...]
    canvas_hw: Tuple[int, int]
    k_peaks: int
    c_max: int
    nms_cap: int
    k_ang: int
    layer_scores: Tuple[float, ...]
    border_color: int
    cfg: MatchConfig


def _make_plan(src_hw, pattern: LearnedPattern, cfg: MatchConfig) -> _Plan:
    top = pattern.top_layer
    shapes = tuple(pattern.shapes)
    top_hw = shapes[top]
    angles = tuple(geometry.angle_schedule(
        top_hw, cfg.tolerance_angle, cfg.tolerance_ranges))
    src_sizes = geometry.pyramid_sizes(src_hw, top)
    src_top_hw = src_sizes[top]
    src_top_wh = (src_top_hw[1], src_top_hw[0])
    templ_top_wh = (top_hw[1], top_hw[0])
    best = [geometry.best_rotation_size(src_top_wh, templ_top_wh, a)
            for a in angles]
    canvas_w = max(max(b[0] for b in best), templ_top_wh[0])
    canvas_h = max(max(b[1] for b in best), templ_top_wh[1])

    layer_scores = [cfg.score]
    for _ in range(top):
        layer_scores.append(layer_scores[-1] * 0.9)

    k_peaks = cfg.max_pos + MATCH_CANDIDATE_NUM
    c_max = min(cfg.effective_max_candidates, len(angles) * k_peaks)
    # NMS column cap: the pair-area matrix covers only the top nms_cap
    # score-sorted candidates. Exact whenever the number of
    # above-final-threshold candidates fits (finalize flags an overflow and
    # match_arrays re-dispatches with the cap lifted — rare).
    nms_cap = min(c_max, max(4 * cfg.max_pos + 64, 128))
    single_angle = (cfg.tolerance_ranges is None
                    and cfg.tolerance_angle < VISION_TOLERANCE)
    return _Plan(
        src_hw=tuple(src_hw), templ_shapes=shapes, top=top,
        stop=1 if cfg.fast_mode else 0, angles=angles,
        canvas_hw=(canvas_h, canvas_w), k_peaks=k_peaks, c_max=c_max,
        nms_cap=nms_cap, k_ang=1 if single_angle else 3,
        layer_scores=tuple(layer_scores), border_color=pattern.border_color,
        cfg=cfg)


def _top_sweep_arrays(plan: _Plan):
    """Host-computed per-angle constants: inverse warp maps, translations,
    valid score-map extents (all static given the plan)."""
    sh, sw = geometry.pyramid_sizes(plan.src_hw, plan.top)[plan.top]
    cx, cy = (sw - 1) / 2.0, (sh - 1) / 2.0
    th, tw = plan.templ_shapes[plan.top]
    inv_mats, trans, valid_wh = [], [], []
    for a in plan.angles:
        bw, bh = geometry.best_rotation_size((sw, sh), (tw, th), a)
        t = ((bw - 1) / 2.0 - cx, (bh - 1) / 2.0 - cy)
        m = geometry.rotation_matrix((cx, cy), a)
        m[0, 2] += t[0]
        m[1, 2] += t[1]
        inv_mats.append(geometry.invert_affine(m))
        trans.append(t)
        valid_wh.append((bw, bh))
    return (np.array(inv_mats, np.float32), np.array(trans, np.float32),
            np.array(valid_wh, np.int32), np.array(plan.angles, np.float32))


def build_stages(plan: _Plan, stats, thr=None, narrow_hook=None):
    """Build the pipeline stage functions for a static plan.

    Returns a namespace of pure, trace-compatible functions; the single-chip
    match program composes them, and parallel.matcher re-composes the same
    stages inside a shard_map with collectives between them.

    thr: optional traced [top+1] f32 array of per-layer score thresholds
    (thr[l] = score * 0.9^l; thr[0] doubles as the final cut). When given,
    the compiled program is score-agnostic — every config that differs
    only in `score` shares one XLA program (the _stats_key idea
    generalized to thresholds). None bakes plan.layer_scores as constants
    (the sharded/profiling composition paths).

    narrow_hook: optional fn(ptLT, ang, score, alive) -> alive used by the
    angle-sharded composition (parallel/matcher.py) to perform candidate
    narrowing GLOBALLY (collective top-cl over all shards) instead of the
    local physical truncation — keeping narrow_candidates exact under
    sharding.
    """
    cfg = plan.cfg
    if thr is None:
        thr = jnp.asarray(plan.layer_scores, jnp.float32)
    top, stop = plan.top, plan.stop
    th_t, tw_t = plan.templ_shapes[top]
    Hc, Wc = plan.canvas_hw
    A = len(plan.angles)
    K = plan.k_peaks
    C = plan.c_max
    k_ang = plan.k_ang

    src_sizes = geometry.pyramid_sizes(plan.src_hw, top)
    def sweep_maps(src_top, templ_top, inv_mats, valid_wh):
        """Per-angle score-map peaks for an arbitrary angle subset:
        [a, 2, 3], [a, 2] -> vals [a, K], locs [a, K, 2]. This is the
        shardable unit — each device sweeps its own angle shard."""
        stats_top = stats[top]
        n_ang = inv_mats.shape[0]
        xs = jax.lax.broadcasted_iota(jnp.int32, (Hc - th_t + 1, Wc - tw_t + 1), 1)
        ys = jax.lax.broadcasted_iota(jnp.int32, (Hc - th_t + 1, Wc - tw_t + 1), 0)

        identity_sweep = (len(plan.angles) == 1 and plan.angles[0] == 0.0)

        def sweep_chunk(args):
            inv_m, vwh = args
            if identity_sweep:
                # tol=0: the rotation canvas IS the source (best size =
                # source size, zero translation) — no warp needed.
                canv = jnp.broadcast_to(src_top, (inv_m.shape[0],) +
                                        src_top.shape)
                if src_top.shape != (Hc, Wc):
                    canv = jnp.pad(
                        canv, ((0, 0), (0, Hc - src_top.shape[0]),
                               (0, Wc - src_top.shape[1])),
                        constant_values=float(plan.border_color))
            else:
                canv = warp_affine_batch(
                    src_top, inv_m, (Hc, Wc), float(plan.border_color),
                    quantize=cfg.quantize_warp)
            smap = ncc_score_map(
                canv, templ_top, stats_top[0], stats_top[1], stats_top[2],
                stats_top[3], cfg.compute_dtype)
            ok = ((xs[None] <= (vwh[:, 0] - tw_t)[:, None, None])
                  & (ys[None] <= (vwh[:, 1] - th_t)[:, None, None]))
            smap = jnp.where(ok, smap, jnp.float32(-1.0))
            vals, locs = extract_peaks(smap, K, (tw_t, th_t), cfg.max_overlap)
            return vals, locs

        chunk = max(1, _CHUNK_BUDGET_ELEMS // (Hc * Wc * 4))
        return chunked_map(sweep_chunk, (inv_mats, valid_wh), n_ang, chunk)

    def select_candidates(vals, locs, trans, angles_arr):
        """Flatten per-angle peaks, threshold, global top-C (the reference
        sorts all candidates by score, MatchToolDlg.cpp:890). Operates on
        the full (gathered) angle axis."""
        n_ang = vals.shape[0]
        vals_f = vals.reshape(n_ang * K)
        locs_f = locs.reshape(n_ang * K, 2)
        ok = vals_f >= thr[top]
        masked = jnp.where(ok, vals_f, jnp.float32(-1.0))
        top_vals, top_idx = jax.lax.top_k(masked, min(C, masked.shape[0]))
        if top_vals.shape[0] < C:  # pad up to the static candidate count
            pad = C - top_vals.shape[0]
            top_vals = jnp.pad(top_vals, (0, pad), constant_values=-1.0)
            top_idx = jnp.pad(top_idx, (0, pad))
        aidx = top_idx // K
        pt = locs_f[top_idx].astype(jnp.float32) - trans[aidx]
        ang = angles_arr[aidx]
        alive = top_vals >= thr[top]
        return pt, ang, top_vals, alive

    def descend_layer(l, src_l, templ_l, ptLT, ang, score, alive):
        """One pyramid-descent step for all candidates (chunked, with
        alive-masked chunk skipping — the caller sorts alive-first)."""
        stats_l = stats[l]
        Cl = ptLT.shape[0]
        sh_l, sw_l = src_sizes[l]
        th_l, tw_l = plan.templ_shapes[l]
        center = (jnp.float32((sw_l - 1) / 2.0), jnp.float32((sh_l - 1) / 2.0))
        step_deg = geometry.angle_step((th_l, tw_l))
        roi_hw = (th_l + 6, tw_l + 6)

        if k_ang == 1:
            angs = jnp.zeros((Cl, 1), jnp.float32)
        else:
            offs = jnp.array([-step_deg, 0.0, step_deg], jnp.float32)
            angs = ang[:, None] + offs[None, :]

        ptLT2 = ptLT * 2.0

        # Pure-translation fast path (tol=0, single angle 0): one
        # dynamic_slice per candidate + static-shift bilinear — no gather.
        pad_h, pad_w = roi_hw[0] + 8, roi_hw[1] + 8
        src_l_padded = None
        if k_ang == 1:
            src_l_padded = jnp.pad(src_l, ((pad_h, pad_h), (pad_w, pad_w)))

        def _translated_rois(p2):
            # ROI dst (x,y) samples src at (x + p2x - 3, y + p2y - 3).
            sx = p2[:, 0] - 3.0
            sy = p2[:, 1] - 3.0
            x0 = jnp.floor(sx)
            y0 = jnp.floor(sy)
            fx = (sx - x0)[:, None, None]
            fy = (sy - y0)[:, None, None]
            xi = jnp.clip(x0.astype(jnp.int32) + pad_w, 0,
                          src_l_padded.shape[1] - roi_hw[1] - 1)
            yi = jnp.clip(y0.astype(jnp.int32) + pad_h, 0,
                          src_l_padded.shape[0] - roi_hw[0] - 1)
            big = jax.vmap(lambda yy, xx: jax.lax.dynamic_slice(
                src_l_padded, (yy, xx),
                (roi_hw[0] + 1, roi_hw[1] + 1)))(yi, xi)
            out = ((1 - fx) * (1 - fy) * big[:, :-1, :-1]
                   + fx * (1 - fy) * big[:, :-1, 1:]
                   + (1 - fx) * fy * big[:, 1:, :-1]
                   + fx * fy * big[:, 1:, 1:])
            if cfg.quantize_warp:
                out = jnp.round(out)
            return out

        def cand_chunk(args):
            p2, aa = args  # [cc,2], [cc,k_ang]
            cc = p2.shape[0]
            a_flat = aa.reshape(cc * k_ang)
            if k_ang == 1:
                roi = _translated_rois(p2)
            else:
                p2_rep = jnp.repeat(p2, k_ang, axis=0)
                lt_rot = rotate_pt_jnp(p2_rep, jnp.stack(center),
                                       a_flat * D2R)
                shift = -(lt_rot - 3.0)
                invm = make_rotation_invmaps(center, a_flat, shift)
                roi = warp_affine_batch(src_l, invm, roi_hw, 0.0,
                                        quantize=cfg.quantize_warp)
            smap = ncc_score_map(roi, templ_l, stats_l[0], stats_l[1],
                                 stats_l[2], stats_l[3],
                                 cfg.compute_dtype)  # [cc*k, 7, 7]
            flat = smap.reshape(cc * k_ang, 49)
            fi = jnp.argmax(flat, axis=1)
            v = flat[jnp.arange(cc * k_ang), fi]
            py = (fi // 7).astype(jnp.int32)
            px = (fi % 7).astype(jnp.int32)
            border = (px == 0) | (px == 6) | (py == 0) | (py == 6)
            sy = jnp.clip(py - 1, 0, 4)
            sx = jnp.clip(px - 1, 0, 4)
            patch = jax.vmap(
                lambda m, y0, x0: jax.lax.dynamic_slice(m, (y0, x0), (3, 3))
            )(smap, sy, sx)
            return (v.reshape(cc, k_ang),
                    jnp.stack([px, py], -1).reshape(cc, k_ang, 2),
                    border.reshape(cc, k_ang),
                    patch.reshape(cc, k_ang, 3, 3))

        chunk = _descend_chunk(roi_hw, th_l * tw_l, k_ang)
        v, xy, border, patch = chunked_map(cand_chunk, (ptLT2, angs), Cl,
                                           chunk, pred=alive)

        imax = jnp.argmax(v, axis=1)  # strict-greater first-wins, like :993
        ar = jnp.arange(Cl)
        best_v = v[ar, imax]
        best_xy = xy[ar, imax].astype(jnp.float32)
        best_border = border[ar, imax]
        best_ang = angs[ar, imax]
        alive = alive & (best_v >= thr[l])
        score = best_v

        use_subpix = (cfg.use_subpixel and l == 0 and k_ang == 3)
        if use_subpix:
            sub = subpixel_refine(patch, jnp.float32(step_deg * D2R))
            gate = (imax == 1) & ~best_border
            best_xy = jnp.where(gate[:, None], best_xy + sub[:, :2], best_xy)
            best_ang = jnp.where(gate, best_ang + sub[:, 2] * R2D, best_ang)

        pad_lt = rotate_pt_jnp(ptLT2, jnp.stack(center), best_ang * D2R) - 3.0
        pt = best_xy + pad_lt
        pt = rotate_pt_jnp(pt, jnp.stack(center), -best_ang * D2R)
        return pt, best_ang, score, alive

    def unrotate(pt, ang):
        sh_t, sw_t = src_sizes[top]
        center_top = jnp.array([(sw_t - 1) / 2.0, (sh_t - 1) / 2.0],
                               jnp.float32)
        return rotate_pt_jnp(pt, center_top, -ang * D2R)

    def debug_candidates(src, templs, inv_mats, trans, valid_wh, angles_arr):
        """Top-layer candidate dump (the m_bDebugMode analogue,
        MatchToolDlg.cpp:897-931): every extracted+thresholded sweep peak
        as [C, 5] = (x, y at level-0 scale, angle deg, score, alive)."""
        pyr = build_pyramid(prep_src(src), top)
        vals, locs = sweep_maps(pyr[top], templs[top], inv_mats, valid_wh)
        pt, ang, score, alive = select_candidates(vals, locs, trans,
                                                  angles_arr)
        ptLT = unrotate(pt, ang) * (2.0 ** top)
        return jnp.concatenate(
            [ptLT, ang[:, None], score[:, None],
             alive.astype(jnp.float32)[:, None]], axis=1)

    def descend_range(pyr, templs, ptLT, ang, score, alive, l_from, l_to):
        """Pyramid descent over layers l_from..l_to (inclusive, downward)."""
        for l in range(l_from, l_to - 1, -1):
            th_l, tw_l = plan.templ_shapes[l]
            roi_hw_l = (th_l + 6, tw_l + 6)
            # Alive-first stable sort (exact — only reorders; finalize
            # re-sorts by score) so the chunk-skip in descend_layer pays
            # for ceil(n_alive/chunk) chunks only.
            if ptLT.shape[0] > _descend_chunk(roi_hw_l, th_l * tw_l, k_ang):
                key = alive.astype(jnp.float32) * 4.0 + score
                order = jnp.argsort(-key, stable=True)
                ptLT, ang, score, alive = (ptLT[order], ang[order],
                                           score[order], alive[order])
            # Divergence knob: below large layers, narrow the static
            # candidate set to the top scorers (the reference refines every
            # candidate; with the generous bound this only drops candidates
            # that cannot reach the top max_pos). Tie-break is the
            # deterministic finalize convention (score desc, then y, x,
            # angle), NOT array order: the kept multiset is then a pure
            # function of the candidate VALUES, so the angle-sharded
            # descent (which sees the same candidates in a different
            # partition/order) keeps the same set via narrow_hook below.
            if cfg.narrow_candidates and th_l * tw_l > 4096:
                if narrow_hook is not None:
                    # Sharded path: the hook narrows the GLOBAL candidate
                    # set (collective) and returns an updated alive mask —
                    # shapes stay fixed; dropped candidates just die.
                    alive = narrow_hook(ptLT, ang, score, alive)
                else:
                    cl = min(ptLT.shape[0], max(2 * cfg.max_pos + 4, 16))
                    if cl < ptLT.shape[0]:
                        key = jnp.where(alive, score, jnp.float32(-2.0))
                        order = jnp.lexsort(
                            (ang, ptLT[:, 0], ptLT[:, 1], -key))[:cl]
                        ptLT, ang, score, alive = (ptLT[order], ang[order],
                                                   score[order],
                                                   alive[order])
            ptLT, ang, score, alive = descend_layer(
                l, pyr[l], templs[l], ptLT, ang, score, alive)
        return ptLT, ang, score, alive

    def descend(pyr, templs, pt, ang, score, alive):
        """Initial un-rotation + full pyramid descent to the stop layer."""
        ptLT = unrotate(pt, ang)

        if top <= stop:
            scale = 1.0 if top == 0 else 2.0
            return ptLT * scale, ang, score, alive
        ptLT, ang, score, alive = descend_range(
            pyr, templs, ptLT, ang, score, alive, top - 1, stop)
        scale = 1.0 if stop == 0 else 2.0
        return ptLT * scale, ang, score, alive

    def finalize(final_pt, final_ang, score, alive):
        ang = final_ang
        # FilterWithScore (MatchToolDlg.cpp:1481-1497): sort desc + cut.
        ok = alive & (score >= thr[0])
        svals = jnp.where(ok, score, jnp.float32(-1.0))
        # Deterministic tie-break (score desc, then y, x, angle): the greedy
        # NMS order must not depend on candidate array order, which differs
        # between the single-chip descent and the angle-sharded descent
        # (parallel/matcher.py) — exact ties would otherwise make
        # sharded != single-chip.
        order = jnp.lexsort((final_ang, final_pt[:, 0], final_pt[:, 1],
                             -svals))
        score_s = svals[order]
        pt_s = final_pt[order]
        ang_s = final_ang[order]
        ok_s = ok[order]

        # FilterWithRotatedRect (:1498-1557) on stop-layer-scaled dims.
        th0, tw0 = plan.templ_shapes[stop]
        rw = tw0 * (1.0 if stop == 0 else 2.0)
        rh = th0 * (1.0 if stop == 0 else 2.0)
        quads = rotated_rect_corners(pt_s, ang_s, rw, rh)
        # NMS over the top nms_cap candidates only (score-sorted, valid
        # first). Exact when all valid candidates fit; otherwise the
        # overflow flag makes match_arrays re-dispatch uncapped.
        cap = plan.nms_cap
        C_all = quads.shape[0]
        if cap < C_all:
            keep = jnp.concatenate([
                filter_overlaps(quads[:cap], ok_s[:cap], rw * rh,
                                cfg.max_overlap),
                jnp.zeros(C_all - cap, bool)])
            overflow = jnp.sum(ok_s.astype(jnp.int32)) > cap
        else:
            keep = filter_overlaps(quads, ok_s, rw * rh, cfg.max_overlap)
            overflow = jnp.asarray(False)

        svals2 = jnp.where(keep, score_s, jnp.float32(-1.0))
        if svals2.shape[0] < cfg.max_pos:  # narrowed below max_pos
            pad = cfg.max_pos - svals2.shape[0]
            svals2 = jnp.pad(svals2, (0, pad), constant_values=-1.0)
            pt_s = jnp.pad(pt_s, ((0, pad), (0, 0)))
            ang_s = jnp.pad(ang_s, (0, pad))
            keep = jnp.pad(keep, (0, pad))
        ord2 = jnp.argsort(-svals2, stable=True)[: cfg.max_pos]
        r_score = svals2[ord2]
        r_pt = pt_s[ord2]
        r_ang = ang_s[ord2]
        r_ok = keep[ord2] & (svals2[ord2] >= 0)

        # Result assembly (MatchToolDlg.cpp:1082-1099): level-0 dims, angle
        # negation + wrap to (-180, 180].
        H0, W0 = plan.templ_shapes[0]
        corners = rotated_rect_corners(r_pt, r_ang, float(W0), float(H0))
        center = jnp.mean(corners, axis=-2)
        out_ang = -r_ang
        out_ang = jnp.where(out_ang < -180.0, out_ang + 360.0, out_ang)
        out_ang = jnp.where(out_ang > 180.0, out_ang - 360.0, out_ang)
        return dict(score=r_score, angle=out_ang, corners=corners,
                    center=center, valid=r_ok, nms_overflow=overflow)

    def prep_src(src):
        """Input normalization shared by every entry point: u8-contract
        clip (device inputs can't be validated host-side; the exact bf16
        correlation needs u8 values) + bitwise-not."""
        src = jnp.clip(src, 0.0, 255.0)
        if cfg.bitwise_not:
            src = 255.0 - src
        return src

    def match_from_pyr(pyr, templs, inv_mats, trans, valid_wh, angles_arr):
        """Full match given an already-built source pyramid — the shared
        core of match_fn and the glyph-batched program (models/batch.py),
        which hoists the pyramid out of its per-template loop."""
        vals, locs = sweep_maps(pyr[top], templs[top], inv_mats, valid_wh)
        pt, ang, score, alive = select_candidates(vals, locs, trans,
                                                  angles_arr)
        final_pt, final_ang, score, alive = descend(pyr, templs, pt, ang,
                                                    score, alive)
        return finalize(final_pt, final_ang, score, alive)

    def match_fn(src, templs, inv_mats, trans, valid_wh, angles_arr):
        pyr = build_pyramid(prep_src(src), top)
        return match_from_pyr(pyr, templs, inv_mats, trans, valid_wh,
                              angles_arr)

    class _Stages:
        pass

    # Split layer for two-phase adaptive compaction: the first (highest)
    # layer whose template is large enough that per-candidate cost
    # dominates. None = no split (small templates).
    split = None
    for l in range(top - 1, stop - 1, -1):
        if plan.templ_shapes[l][0] * plan.templ_shapes[l][1] > 4096:
            split = l
            break
    if split is not None and split == top - 1:
        split = None  # nothing cheap to run first

    def phase_a(src, templs, inv_mats, trans, valid_wh, angles_arr):
        """Pyramid + sweep + cheap upper descent; returns carry state and
        the pyramid levels still needed by phase B."""
        pyr = build_pyramid(prep_src(src), top)
        vals, locs = sweep_maps(pyr[top], templs[top], inv_mats, valid_wh)
        pt, ang, score, alive = select_candidates(vals, locs, trans,
                                                  angles_arr)
        ptLT = unrotate(pt, ang)
        ptLT, ang, score, alive = descend_range(
            pyr, templs, ptLT, ang, score, alive, top - 1, split + 1)
        return (ptLT, ang, score, alive), tuple(pyr[stop:split + 1])

    def phase_b(state, pyr_low, templs):
        """Expensive low-layer descent on a compacted candidate set +
        finalize. pyr_low = (pyr[stop], ..., pyr[split])."""
        ptLT, ang, score, alive = state
        pyr = [None] * stop + list(pyr_low)
        ptLT, ang, score, alive = descend_range(
            pyr, templs, ptLT, ang, score, alive, split, stop)
        scale = 1.0 if stop == 0 else 2.0
        return finalize(ptLT * scale, ang, score, alive)

    st = _Stages()
    st.plan = plan
    st.descend_layer = descend_layer
    st.descend_range = descend_range
    st.sweep_maps = sweep_maps
    st.select_candidates = select_candidates
    st.unrotate = unrotate
    st.descend = descend
    st.finalize = finalize
    st.prep_src = prep_src
    st.match_from_pyr = match_from_pyr
    st.match_fn = match_fn
    st.debug_candidates = debug_candidates
    st.split = split
    st.phase_a = phase_a
    st.phase_b = phase_b
    return st


def _stats_key(stats):
    """Only the flat-template flags are compile-time; numeric stats are
    traced so same-shape templates (e.g. glyph sets) share one program
    (at most two variants per shape, one per border color)."""
    return tuple(bool(s[3]) for s in stats)


def _shared_plan(plan: _Plan) -> _Plan:
    """Compile-cache key: the plan with the score threshold scrubbed.
    Thresholds are traced (build_stages thr arg), so configs that differ
    only in `score` share one compiled program."""
    return dataclasses.replace(
        plan, layer_scores=(),
        cfg=dataclasses.replace(plan.cfg, score=0.0))


@functools.lru_cache(maxsize=128)
def _thr_dev(layer_scores: Tuple[float, ...]):
    """Device copy of the per-layer thresholds, cached per value tuple
    (one tiny upload per distinct score, not per call)."""
    return jnp.asarray(layer_scores, jnp.float32)


@functools.lru_cache(maxsize=128)
def _traced_stats_tuple(stats):
    """Device scalars for the traced numeric stats. Cached on the (pure
    Python floats) stats tuple: without this every match() call uploads
    ~3*levels tiny scalars — ~21 host->device transfers per call."""
    return tuple((jnp.float32(s[0]), jnp.float32(s[1]), jnp.float32(s[2]),
                  s[3]) for s in stats)


def _pack_result(out, max_pos):
    """Pack the result dict into one [max_pos + 1, 13] f32 array (rows:
    score, angle, center xy, corners 8, valid; final row carries the NMS
    overflow flag) — a single host transfer."""
    rows = jnp.concatenate([
        out["score"][:, None], out["angle"][:, None], out["center"],
        out["corners"].reshape(max_pos, 8),
        out["valid"].astype(jnp.float32)[:, None]], axis=1)
    flag = jnp.full((1, rows.shape[1]),
                    out["nms_overflow"].astype(jnp.float32))
    return jnp.concatenate([rows, flag], axis=0)


def _unpack_result(packed):
    packed = np.asarray(packed)
    flag = packed[-1, 0] > 0.5
    packed = packed[:-1]
    mp = packed.shape[0]
    return {
        "score": packed[:, 0].astype(np.float32),
        "angle": packed[:, 1].astype(np.float32),
        "center": packed[:, 2:4].astype(np.float32),
        "corners": packed[:, 4:12].reshape(mp, 4, 2).astype(np.float32),
        "valid": packed[:, 12] > 0.5,
        "nms_overflow": bool(flag),
    }


@functools.lru_cache(maxsize=32)
def _compiled(plan: _Plan, equal1_key):
    def fn(src, templs, tstats, inv_mats, trans, valid_wh, angles_arr, thr):
        stats = tuple((t[0], t[1], t[2], e)
                      for t, e in zip(tstats, equal1_key))
        out = build_stages(plan, stats, thr).match_fn(
            src, templs, inv_mats, trans, valid_wh, angles_arr)
        return _pack_result(out, plan.cfg.max_pos)
    return jax.jit(fn)


@functools.lru_cache(maxsize=32)
def _compiled_phase_a(plan: _Plan, equal1_key):
    def fn(src, templs, tstats, inv_mats, trans, valid_wh, angles_arr, thr):
        stats = tuple((t[0], t[1], t[2], e)
                      for t, e in zip(tstats, equal1_key))
        (ptLT, ang, score, alive), pyr_low = build_stages(
            plan, stats, thr).phase_a(src, templs, inv_mats, trans, valid_wh,
                                      angles_arr)
        packed = jnp.concatenate(
            [ptLT, ang[:, None], score[:, None],
             alive.astype(jnp.float32)[:, None]], axis=1)  # [C, 5]
        return packed, pyr_low
    return jax.jit(fn)


@functools.lru_cache(maxsize=64)
def _compiled_phase_b(plan: _Plan, equal1_key, c_compact: int):
    def fn(packed, pyr_low, templs, tstats, thr):
        stats = tuple((t[0], t[1], t[2], e)
                      for t, e in zip(tstats, equal1_key))
        state = (packed[:, 0:2], packed[:, 2], packed[:, 3],
                 packed[:, 4] > 0.5)
        out = build_stages(plan, stats, thr).phase_b(state, pyr_low, templs)
        return _pack_result(out, plan.cfg.max_pos)
    return jax.jit(fn)


@functools.lru_cache(maxsize=8)
def _compiled_debug(plan: _Plan, equal1_key):
    def fn(src, templs, tstats, inv_mats, trans, valid_wh, angles_arr, thr):
        stats = tuple((t[0], t[1], t[2], e)
                      for t, e in zip(tstats, equal1_key))
        return build_stages(plan, stats, thr).debug_candidates(
            src, templs, inv_mats, trans, valid_wh, angles_arr)
    return jax.jit(fn)


@functools.lru_cache(maxsize=32)
def _plan_device_arrays(plan: _Plan):
    """Per-plan constant arrays, uploaded once and cached on device."""
    inv_mats, trans, valid_wh, angles_arr = _top_sweep_arrays(plan)
    return (jnp.asarray(inv_mats), jnp.asarray(trans),
            jnp.asarray(valid_wh), jnp.asarray(angles_arr))


_PATTERN_DEV_CACHE = {}


def _get_pattern_dev(pattern: LearnedPattern):
    """Device copies of the template pyramid, cached per pattern object.

    The entry holds the pattern itself: an id()-keyed cache without the
    reference would serve STALE device arrays when a garbage-collected
    pattern's address is reused by a new one."""
    key = id(pattern)
    hit = _PATTERN_DEV_CACHE.get(key)
    if hit is None or hit[0] is not pattern:
        arrs = tuple(jnp.asarray(lv.templ) for lv in pattern.levels)
        if len(_PATTERN_DEV_CACHE) > 64:
            _PATTERN_DEV_CACHE.pop(next(iter(_PATTERN_DEV_CACHE)))
        _PATTERN_DEV_CACHE[key] = (pattern, arrs)
        return arrs
    return hit[1]


def _bucket(n: int, cap: int) -> int:
    """Power-of-two candidate bucket (>= 4) for phase-B compile caching."""
    b = 4
    while b < n:
        b *= 2
    return min(b, cap)


@functools.lru_cache(maxsize=64)
def _stage_split(plan: _Plan, equal1_key):
    dummy = tuple((0.0, 1.0, 1.0, e) for e in equal1_key)
    return build_stages(plan, dummy).split


class TemplateMatcher:
    """Convenience OO wrapper mirroring the Qt TemplateMatcher surface
    (include/TemplateMatcher.h:16-51): learnPattern / match / param setters.
    The functional core stays pure; this class only holds config + pattern.
    """

    def __init__(self, config: Optional[MatchConfig] = None):
        self.config = config or MatchConfig()
        self.pattern: Optional[LearnedPattern] = None

    def learn_pattern(self, templ: np.ndarray) -> None:
        self.pattern = learn_pattern(templ, self.config.min_reduce_area)

    def match(self, src: np.ndarray) -> List[MatchResult]:
        if self.pattern is None:
            raise RuntimeError("learn_pattern must be called first")
        return match(src, self.pattern, self.config)

    # --- parameter setters mirroring include/TemplateMatcher.h:16-51 ---
    def _set(self, **kw) -> None:
        self.config = dataclasses.replace(self.config, **kw)

    def set_max_positions(self, n: int) -> None:
        self._set(max_pos=n)

    def set_max_overlap(self, v: float) -> None:
        self._set(max_overlap=v)

    def set_score(self, v: float) -> None:
        self._set(score=v)

    def set_tolerance_angle(self, v: float) -> None:
        self._set(tolerance_angle=v)

    def set_min_reduce_area(self, v: int) -> None:
        # Changing the pyramid depth invalidates the learned pattern, like
        # re-learning after a parameter change in the reference UI.
        self._set(min_reduce_area=v)
        self.pattern = None

    def set_sub_pixel(self, enabled: bool) -> None:
        self._set(use_subpixel=enabled)

    def set_tolerance_ranges(self, t1: float, t2: float, t3: float,
                             t4: float) -> None:
        self._set(tolerance_ranges=(t1, t2, t3, t4))


def _prepare(src, pattern: LearnedPattern, cfg: MatchConfig):
    """Shared input prep: guards, plan, stats, device arrays."""
    # Device-resident sources (jax arrays) are used as-is — the serving
    # path uploads once and matches many times (device-resident input is the
    # analogue of the reference's image-in-RAM timing).
    if not isinstance(src, jnp.ndarray):
        src = np.asarray(src)
    if src.ndim == 3:
        from ..utils.imageio import ensure_gray
        src = ensure_gray(src)
    # u8-value contract (the reference operates on 8-bit images throughout;
    # the bf16 correlation additionally relies on it for exactness). Host
    # arrays that are not already uint8 are validated loudly; device-
    # resident arrays can't be checked without a readback — the compiled
    # program clips them instead (see build_stages), so out-of-contract
    # device inputs degrade to defined clipping.
    if isinstance(src, np.ndarray) and src.dtype != np.uint8:
        lo, hi = float(src.min()), float(src.max())
        if lo < 0.0 or hi > 255.0:
            raise ValueError(
                f"source values must lie in [0, 255] (8-bit contract, "
                f"got range [{lo}, {hi}]); rescale 16-bit imagery first")
    # Guards per Match() (MatchToolDlg.cpp:774-781).
    t0 = pattern.levels[0].templ
    if (t0.shape[0] > src.shape[0] and t0.shape[1] < src.shape[1]) or \
       (t0.shape[0] < src.shape[0] and t0.shape[1] > src.shape[1]):
        raise ValueError("template/source size relation unsupported")
    if t0.shape[0] * t0.shape[1] > src.shape[0] * src.shape[1]:
        raise ValueError("template larger than source")

    plan = _make_plan(src.shape, pattern, cfg)
    stats = tuple((lv.mean, lv.norm, lv.inv_area, lv.result_equal1)
                  for lv in pattern.levels)
    templs = _get_pattern_dev(pattern)
    src_dev = src if isinstance(src, jnp.ndarray) else jnp.asarray(
        src, jnp.float32)
    if src_dev.dtype != jnp.float32:
        src_dev = src_dev.astype(jnp.float32)
    tstats = _traced_stats_tuple(stats)
    ekey = _stats_key(stats)
    args = (src_dev, templs, tstats) + _plan_device_arrays(plan) \
        + (_thr_dev(plan.layer_scores),)
    return plan, ekey, args


def match_candidates(src: np.ndarray, pattern: LearnedPattern,
                     cfg: Optional[MatchConfig] = None) -> Dict[str, np.ndarray]:
    """Debug candidate dump — every thresholded top-layer sweep peak before
    refinement, the analogue of the reference's m_bDebugMode candidate
    overlay (MatchToolDlg.cpp:897-931). Returns dict of [C] arrays:
    x, y (LT corner at level-0 scale, top-layer frame), angle (deg, sweep
    convention), score (top-layer NCC), alive (above layer threshold)."""
    cfg = cfg or MatchConfig()
    plan, ekey, args = _prepare(src, pattern, cfg)
    packed = np.asarray(_compiled_debug(_shared_plan(plan), ekey)(*args))
    return {
        "x": packed[:, 0], "y": packed[:, 1], "angle": packed[:, 2],
        "score": packed[:, 3], "alive": packed[:, 4] > 0.5,
    }


def match_arrays(src: np.ndarray, pattern: LearnedPattern,
                 cfg: MatchConfig) -> Dict[str, np.ndarray]:
    """Run the compiled pipeline; returns fixed-size result arrays
    (score/angle/corners/center [max_pos], valid mask)."""
    plan, ekey, args = _prepare(src, pattern, cfg)
    out = _dispatch(plan, ekey, args, cfg)
    if out.pop("nms_overflow", False) and plan.nms_cap < plan.c_max:
        # More above-threshold candidates than the NMS cap — re-dispatch
        # with the cap lifted for the exact uncapped greedy result.
        plan_full = dataclasses.replace(plan, nms_cap=plan.c_max)
        out = _dispatch(plan_full, ekey, args, cfg)
        out.pop("nms_overflow", None)
    return out


def _dispatch(plan: _Plan, ekey, args, cfg) -> Dict[str, np.ndarray]:
    # Two-phase adaptive compaction: run the cheap upper layers, read the
    # survivor count on host, then dispatch the expensive low layers with a
    # right-sized (power-of-two bucketed) candidate set. Exactly equivalent
    # to the single program — only already-dead candidates are dropped.
    # Host<->device traffic is packed into single arrays per direction.
    templs, tstats = args[1], args[2]
    if cfg.two_phase:
        st_meta = _stage_split(_shared_plan(plan), ekey)
        if st_meta is not None:
            packed, pyr_low = _compiled_phase_a(_shared_plan(plan),
                                                ekey)(*args)
            ph = np.asarray(packed)  # one transfer: [C, 5]
            alive = ph[:, 4] > 0.5
            n_alive = int(alive.sum())
            if n_alive == 0:
                mp = cfg.max_pos
                return {
                    "score": np.full(mp, -1.0, np.float32),
                    "angle": np.zeros(mp, np.float32),
                    "corners": np.zeros((mp, 4, 2), np.float32),
                    "center": np.zeros((mp, 2), np.float32),
                    "valid": np.zeros(mp, bool),
                    "nms_overflow": False,
                }
            c2 = _bucket(n_alive, ph.shape[0])
            key = np.where(alive, ph[:, 3], -2.0)
            order = np.argsort(-key, kind="stable")[:c2]
            out = _compiled_phase_b(_shared_plan(plan), ekey, c2)(
                jnp.asarray(ph[order]), pyr_low, templs, tstats, args[-1])
            return _unpack_result(out)

    fn = _compiled(_shared_plan(plan), ekey)
    return _unpack_result(fn(*args))


def match(src: np.ndarray, pattern: LearnedPattern,
          cfg: Optional[MatchConfig] = None) -> List[MatchResult]:
    """Find template instances in src; returns MatchResults sorted by score
    desc, at most cfg.max_pos entries."""
    cfg = cfg or MatchConfig()
    out = match_arrays(src, pattern, cfg)
    results = []
    for i in range(out["valid"].shape[0]):
        if not out["valid"][i]:
            continue
        c = out["corners"][i]
        r = MatchResult(
            score=float(out["score"][i]), angle=float(out["angle"][i]),
            center=tuple(out["center"][i].tolist()),
            lt=tuple(c[0].tolist()), rt=tuple(c[1].tolist()),
            rb=tuple(c[2].tolist()), lb=tuple(c[3].tolist()))
        if pattern.regions:
            # Marked regions projected into this match's source frame
            # (drawUserPolygonOnResults, src/MatchToolDialog.cpp:1444-1478).
            r.regions = tuple(r.project_points(reg)
                              for reg in pattern.regions)
        results.append(r)
    return results


def match_template(src: np.ndarray, templ: np.ndarray,
                   method: str = "auto",
                   compute_dtype: str = "bf16") -> np.ndarray:
    """Plain full-resolution TM_CCOEFF_NORMED score map — the
    cv::matchTemplate-equivalent no-pyramid path (BASELINE config 1).

    method: "conv" (implicit-GEMM convolution), "fft" (frequency-domain
    cross-correlation, best for large template x large source), "auto".
    """
    src = np.asarray(src)
    templ = np.asarray(templ)
    if src.ndim == 3:
        from ..utils.imageio import ensure_gray
        src = ensure_gray(src)
    if templ.ndim == 3:
        from ..utils.imageio import ensure_gray
        templ = ensure_gray(templ)
    area = templ.size
    mean = float(np.mean(templ, dtype=np.float64))
    var = float(np.mean((templ.astype(np.float64) - mean) ** 2))
    norm = float(np.sqrt(var) * np.sqrt(area))
    out = ncc_score_map(
        jnp.asarray(src, jnp.float32)[None], jnp.asarray(templ, jnp.float32),
        mean, norm, 1.0 / area, var < DBL_EPSILON, compute_dtype, method)
    return np.asarray(out[0])
