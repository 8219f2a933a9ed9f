"""Test oracle: a direct OpenCV-based implementation of the reference's
Match() pipeline (MatchTool/MatchToolDlg.cpp:772-1148), used ONLY to
cross-validate the JAX implementation end-to-end.

Uses cv2's own primitives exactly like the reference does — buildPyramid,
getRotationMatrix2D/warpAffine, matchTemplate(TM_CCOEFF_NORMED) (== the
reference's TM_CCORR + CCOEFF_Denominator), minMaxLoc, and
rotatedRectangleIntersection — so agreement between this oracle and the
JAX pipeline demonstrates behavioral parity with the reference
algorithm independent of our own recorded goldens.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List

import cv2
import numpy as np

from fastest_image_pattern_matching_tpu.config import (MATCH_CANDIDATE_NUM,
                                                       VISION_TOLERANCE)
from fastest_image_pattern_matching_tpu.utils import geometry

D2R = math.pi / 180.0
R2D = 180.0 / math.pi


@dataclass
class OracleMatch:
    score: float
    angle: float
    x: float
    y: float


def _top_layer(templ, min_reduce_area):
    return geometry.top_layer(templ.shape, min_reduce_area)


def _build_pyr(img, levels):
    out = [img]
    for _ in range(levels):
        out.append(cv2.pyrDown(out[-1]))
    return out


def _peaks(score, k, tw, th, overlap, thresh):
    m = score.copy()
    out = []
    sw = int(2 * tw * (1 - overlap))
    sh = int(2 * th * (1 - overlap))
    for i in range(k):
        _, v, _, (x, y) = cv2.minMaxLoc(m)
        if v < thresh:
            break
        out.append((v, x, y))
        x0 = int(x - tw * (1 - overlap))
        y0 = int(y - th * (1 - overlap))
        cv2.rectangle(m, (x0, y0), (x0 + sw - 1, y0 + sh - 1), -1.0, -1)
    return out


def _subpix(patches, step_deg):
    A, S = [], []
    for t in range(3):
        for y in (-1, 0, 1):
            for x in (-1, 0, 1):
                dt = (t - 1) * step_deg * D2R
                A.append([x * x, y * y, dt * dt, x * y, x * dt, y * dt,
                          x, y, dt, 1.0])
                S.append(patches[t][y + 1][x + 1])
    A = np.array(A)
    S = np.array(S)
    z = np.linalg.lstsq(A, S, rcond=None)[0]
    K1 = np.array([[2 * z[0], z[3], z[4]], [z[3], 2 * z[1], z[5]],
                   [z[4], z[5], 2 * z[2]]])
    K2 = -np.array([z[6], z[7], z[8]])
    try:
        d = np.linalg.solve(K1, K2)
    except np.linalg.LinAlgError:
        return 0.0, 0.0, 0.0
    return float(d[0]), float(d[1]), float(d[2]) * R2D


def oracle_match(src: np.ndarray, templ: np.ndarray, max_pos=10,
                 max_overlap=0.1, score=0.7, tolerance_angle=180.0,
                 min_reduce_area=256, use_subpixel=True,
                 fast_mode=False, tolerance_ranges=None) -> List[OracleMatch]:
    """fast_mode mirrors m_bStopLayer1: descent stops at layer 1; final
    positions scale x2, the NMS rects use the layer-1 template dims x2,
    result corners still use the level-0 dims (as the JAX finalize
    does)."""
    stop = 1 if fast_mode else 0
    src = np.asarray(src, np.uint8)
    templ = np.asarray(templ, np.uint8)
    top = _top_layer(templ, min_reduce_area)
    tpyr = _build_pyr(templ, top)
    spyr = _build_pyr(src, top)
    border = 255 if float(templ.mean()) < 128 else 0

    angles = geometry.angle_schedule(tpyr[top].shape, tolerance_angle,
                                     tolerance_ranges)
    layer_scores = [score * (0.9 ** l) for l in range(top + 1)]

    sh, sw = spyr[top].shape
    cx, cy = (sw - 1) / 2.0, (sh - 1) / 2.0
    th_t, tw_t = tpyr[top].shape

    cands = []  # (score, pt, angle)
    for a in angles:
        bw, bh = geometry.best_rotation_size((sw, sh), (tw_t, th_t), a)
        if bw < tw_t or bh < th_t:
            continue
        tx = (bw - 1) / 2.0 - cx
        ty = (bh - 1) / 2.0 - cy
        m = geometry.rotation_matrix((cx, cy), a)
        m[0, 2] += tx
        m[1, 2] += ty
        rot = cv2.warpAffine(spyr[top], m, (bw, bh), flags=cv2.INTER_LINEAR,
                             borderMode=cv2.BORDER_CONSTANT,
                             borderValue=border)
        res = cv2.matchTemplate(rot, tpyr[top], cv2.TM_CCOEFF_NORMED)
        for (v, x, y) in _peaks(res, max_pos + MATCH_CANDIDATE_NUM,
                                tw_t, th_t, max_overlap, layer_scores[top]):
            cands.append((v, (x - tx, y - ty), a))
    cands.sort(key=lambda c: -c[0])

    results = []
    for (v, pt, ang) in cands:
        ptLT = geometry.rotate_pt(pt, (cx, cy), -ang * D2R)
        cur_ang = ang
        cur_score = v
        alive = True
        if top <= stop:
            results.append((cur_score, tuple(ptLT), cur_ang))
            continue
        for l in range(top - 1, stop - 1, -1):
            th_l, tw_l = tpyr[l].shape
            sh_l, sw_l = spyr[l].shape
            ccx, ccy = (sw_l - 1) / 2.0, (sh_l - 1) / 2.0
            step = geometry.angle_step((th_l, tw_l))
            if tolerance_ranges is None and \
                    tolerance_angle < VISION_TOLERANCE:
                angs = [0.0]
            else:
                angs = [cur_ang - step, cur_ang, cur_ang + step]
            ptLT2 = np.asarray(ptLT) * 2.0
            best = None
            entries = []
            for j, aj in enumerate(angs):
                lt_rot = geometry.rotate_pt(ptLT2, (ccx, ccy), aj * D2R)
                m = geometry.rotation_matrix((ccx, ccy), aj)
                m[0, 2] -= lt_rot[0] - 3
                m[1, 2] -= lt_rot[1] - 3
                roi = cv2.warpAffine(spyr[l], m, (tw_l + 6, th_l + 6),
                                     flags=cv2.INTER_LINEAR)
                res = cv2.matchTemplate(roi, tpyr[l], cv2.TM_CCOEFF_NORMED)
                _, mv, _, (mx, my) = cv2.minMaxLoc(res)
                on_border = (mx == 0 or my == 0 or mx == res.shape[1] - 1
                             or my == res.shape[0] - 1)
                patch = None
                if not on_border:
                    patch = [[res[my + yy, mx + xx] for xx in (-1, 0, 1)]
                             for yy in (-1, 0, 1)]
                entries.append((mv, float(mx), float(my), aj, on_border,
                                patch))
                if best is None or mv > entries[best][0]:
                    best = j
            bv, bx, by, ba, bborder, _ = entries[best]
            if bv < layer_scores[l]:
                alive = False
                break
            cur_score = bv
            if (use_subpixel and l == 0 and len(angs) == 3 and best == 1
                    and not bborder):
                patches = [entries[j][5] for j in range(3)]
                if all(p is not None for p in patches):
                    dx, dy, da = _subpix(patches, step)
                    bx += dx
                    by += dy
                    ba += da
            pad_lt = geometry.rotate_pt(ptLT2, (ccx, ccy), ba * D2R) - 3.0
            p = np.array([bx + pad_lt[0], by + pad_lt[1]])
            p = geometry.rotate_pt(p, (ccx, ccy), -ba * D2R)
            ptLT = p
            cur_ang = ba
        if alive:
            results.append((cur_score, tuple(ptLT), cur_ang))

    # FilterWithScore + rotated-rect NMS + assembly. With fast_mode the
    # descent stopped at layer 1: positions scale x2 and the NMS rects
    # use the layer-1 template dims x2 (the JAX finalize's convention).
    scale = 2.0 if stop == 1 else 1.0
    results = [(sc, (lt[0] * scale, lt[1] * scale), ang)
               for (sc, lt, ang) in results if sc >= score]
    results.sort(key=lambda r: -r[0])
    H0, W0 = templ.shape
    rh, rw = (tpyr[stop].shape[0] * scale, tpyr[stop].shape[1] * scale) \
        if stop else (float(H0), float(W0))
    keep = []
    for (sc, lt, ang) in results:
        ra = -ang * D2R
        c, s = math.cos(ra), math.sin(ra)
        quad = np.float32([
            lt,
            (lt[0] + rw * c, lt[1] - rw * s),
            (lt[0] + rw * c + rh * s, lt[1] - rw * s + rh * c),
            (lt[0] + rh * s, lt[1] + rh * c)])
        r_new = cv2.minAreaRect(quad)
        dead = False
        for (_, kq) in keep:
            kind, pts = cv2.rotatedRectangleIntersection(
                cv2.minAreaRect(kq), r_new)
            if kind == cv2.INTERSECT_FULL:
                dead = True
                break
            if kind == cv2.INTERSECT_PARTIAL and pts is not None \
                    and len(pts) >= 3:
                area = cv2.contourArea(cv2.convexHull(pts.reshape(-1, 2)))
                if area / (rw * rh) > max_overlap:
                    dead = True
                    break
        if not dead:
            keep.append(((sc, lt, ang), quad))
        if len(keep) >= max_pos:
            break

    out = []
    for ((sc, lt, ang), quad) in keep:
        # Result corners always use the level-0 dims (finalize parity).
        ra = -ang * D2R
        c, s = math.cos(ra), math.sin(ra)
        q0 = np.float32([
            lt,
            (lt[0] + W0 * c, lt[1] - W0 * s),
            (lt[0] + W0 * c + H0 * s, lt[1] - W0 * s + H0 * c),
            (lt[0] + H0 * s, lt[1] + H0 * c)])
        cxy = q0.mean(axis=0)
        oa = -ang
        if oa < -180:
            oa += 360
        if oa > 180:
            oa -= 360
        out.append(OracleMatch(float(sc), float(oa), float(cxy[0]),
                               float(cxy[1])))
    return out
