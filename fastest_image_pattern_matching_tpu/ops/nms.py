"""Rotated-rectangle overlap filtering (NMS) on device.

Reference: FilterWithRotatedRect (MatchTool/MatchToolDlg.cpp:1498-1557)
walks score-sorted candidates pairwise, computes the rotated-rect
intersection polygon (cv::rotatedRectangleIntersection + SortPtWithCenter +
contourArea) and deletes the lower-scored one when fully contained or when
intersection_area / template_area > max_overlap.

Batched formulation: pair intersection areas are computed with a vmapped
fixed-size Sutherland–Hodgman clip (convex quad vs convex quad -> at most
8 vertices), row-chunked with all-invalid-chunk skipping so cost scales
with n_valid * C rather than C^2 (the uncapped default carries up to 2048
candidates, most invalid). The greedy suppression order is then applied by
a round-based lax.while_loop that decides every candidate whose earlier
conflicters are all decided — it terminates in the conflict-chain depth
(2-5 rounds in practice), not C sequential steps, and reproduces
FilterWithRotatedRect's greedy result exactly.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# Vertex-buffer capacity: clipping a convex polygon by a half-plane adds
# at most one vertex, so 4 initial vertices + 4 clip planes bound the
# intersection polygon at 8 (also the classic quad-quad bound); the
# one-hot masks below scale quadratically with it.
_MAXV = 8

# The one-hot selections below move f32 coordinates of up to a few
# thousand pixels; a TF32 product would round them to 2 px steps.
_HIGHEST = jax.lax.Precision.HIGHEST


def _clip_halfplane(pts, cnt, a, b):
    """Clip polygon (pts [N,2], cnt valid) by the half-plane left of a->b
    (cross((b-a), (p-a)) >= 0). Returns (pts', cnt').

    Gather/scatter-free: the ring successor and the compaction write are
    tiny one-hot contractions ([N,N] masks x [N,2] points), so the whole
    clip vectorizes cleanly under vmap over millions of candidate pairs
    with no per-pair scatter."""
    n = pts.shape[0]
    idx = jnp.arange(n)
    cur = pts

    # Ring successor as a one-hot contraction: nxt[i] = pts[(i+1) % cnt].
    succ = jnp.where(idx + 1 >= cnt, 0, idx + 1)
    nxt_oh = (idx[None, :] == succ[:, None]).astype(pts.dtype)  # [n, n]
    nxt = jnp.matmul(nxt_oh, pts, precision=_HIGHEST)

    ex, ey = b[0] - a[0], b[1] - a[1]

    def side(p):
        # cross(b-a, p-a); >= 0 is inside for LT,RT,RB,LB winding in
        # image coords (y down).
        return ex * (p[..., 1] - a[1]) - ey * (p[..., 0] - a[0])

    s_cur = side(cur)
    s_nxt = side(nxt)
    in_cur = s_cur >= 0
    in_nxt = s_nxt >= 0
    crosses = in_cur != in_nxt

    denom = s_cur - s_nxt
    safe_denom = jnp.where(jnp.abs(denom) > 1e-12, denom, 1.0)
    tparam = jnp.where(jnp.abs(denom) > 1e-12, s_cur / safe_denom, 0.0)
    inter = cur + tparam[:, None] * (nxt - cur)

    valid = idx < cnt
    emit_cur = in_cur & valid
    emit_int = crosses & valid

    counts = emit_cur.astype(jnp.int32) + emit_int.astype(jnp.int32)
    offsets = jnp.cumsum(counts) - counts  # exclusive
    # Compaction as two one-hot writes: out[p] = sum_i 1[pos_i == p] v_i.
    pos_cur = offsets
    pos_int = offsets + emit_cur.astype(jnp.int32)
    w_cur = ((pos_cur[None, :] == idx[:, None]) & emit_cur[None, :]
             ).astype(pts.dtype)  # [p, i]
    w_int = ((pos_int[None, :] == idx[:, None]) & emit_int[None, :]
             ).astype(pts.dtype)
    out = (jnp.matmul(w_cur, cur, precision=_HIGHEST)
           + jnp.matmul(w_int, inter, precision=_HIGHEST))
    new_cnt = jnp.sum(counts)
    return out, new_cnt


def quad_intersection_area(quad_a: jnp.ndarray, quad_b: jnp.ndarray):
    """Intersection area of two convex quads given as [4,2] vertex lists in
    consistent winding (LT, RT, RB, LB in image coords)."""
    pts = jnp.zeros((_MAXV, 2), dtype=jnp.float32).at[:4].set(quad_a)
    cnt = jnp.int32(4)
    for k in range(4):
        a = quad_b[k]
        b = quad_b[(k + 1) % 4]
        pts, cnt = _clip_halfplane(pts, cnt, a, b)
    # Shoelace over the valid prefix (one-hot successor, no gather).
    n = pts.shape[0]
    idx = jnp.arange(n)
    succ = jnp.where(idx + 1 >= cnt, 0, idx + 1)
    nxt = jnp.matmul((idx[None, :] == succ[:, None]).astype(pts.dtype), pts,
                     precision=_HIGHEST)
    cross = pts[:, 0] * nxt[:, 1] - nxt[:, 0] * pts[:, 1]
    cross = jnp.where(idx < cnt, cross, 0.0)
    area = 0.5 * jnp.abs(jnp.sum(cross))
    return jnp.where(cnt >= 3, area, 0.0)


def rotated_rect_corners(pt_lt: jnp.ndarray, angle_deg: jnp.ndarray,
                         w: float, h: float) -> jnp.ndarray:
    """Corners [..., 4, 2] (LT, RT, RB, LB) of the matched rect, exactly the
    reference construction (MatchToolDlg.cpp:1058-1063): rotate by
    dRAngle = -angle about LT in image coords."""
    ra = -angle_deg * (jnp.pi / 180.0)
    cosr, sinr = jnp.cos(ra), jnp.sin(ra)
    lt = pt_lt
    rt = jnp.stack([lt[..., 0] + w * cosr, lt[..., 1] - w * sinr], axis=-1)
    lb = jnp.stack([lt[..., 0] + h * sinr, lt[..., 1] + h * cosr], axis=-1)
    rb = jnp.stack([rt[..., 0] + h * sinr, rt[..., 1] + h * cosr], axis=-1)
    return jnp.stack([lt, rt, rb, lb], axis=-2)


def filter_overlaps(
    quads: jnp.ndarray,     # [C, 4, 2] score-sorted (desc) candidate rects
    valid: jnp.ndarray,     # [C] bool
    templ_area: float,
    max_overlap: float,
) -> jnp.ndarray:
    """Greedy suppression; returns the surviving-candidate mask.

    Matches FilterWithRotatedRect: for each surviving i (in score order),
    delete every later j whose intersection with i is full containment or
    has area ratio (vs template area) > max_overlap. 1-2 intersection
    points (zero area) keep both (MatchToolDlg.cpp:1527).
    """
    C = quads.shape[0]
    # Pair areas, chunked along BOTH axes with all-invalid-chunk skipping:
    # the caller passes score-sorted candidates (invalid last); an invalid
    # i never kills and an invalid j needs no kill decision, so skipped
    # chunks safely report zero area. Cost therefore scales with
    # n_valid^2 instead of C^2 (the reference's FilterWithScore also cuts
    # below-threshold candidates before the rect filter,
    # MatchToolDlg.cpp:1050-1067).
    from ..utils.chunking import chunked_map

    col_chunk = min(C, 64)

    def row_chunk(q_rows):
        def cols(q_cols):
            return jax.vmap(lambda qb: jax.vmap(
                lambda qa: quad_intersection_area(qa, qb))(q_rows))(q_cols)
        # [C, rows] (cols-major from the inner chunking), transposed back.
        a = chunked_map(cols, quads, C, col_chunk, pred=valid)
        return a.T

    pair_area = chunked_map(row_chunk, quads, C, min(C, 64),
                            pred=valid)  # [C, C]
    contain = pair_area >= templ_area * (1.0 - 1e-6)
    conflict = contain | (pair_area / templ_area > max_overlap)

    # Round-based exact greedy: candidate j is `decided` once every
    # earlier-conflicting i is decided; then alive[j] = valid[j] and no
    # decided-alive earlier conflicter kills it. Each round decides at
    # least the smallest undecided index (all i < it are decided), so the
    # loop terminates in <= C rounds — in practice 2-5 (conflict-chain
    # depth), each one [C, C] masked reduce, vs C sequential fori steps.
    # Produces exactly FilterWithRotatedRect's greedy result.
    idx = jnp.arange(C)
    earlier = conflict & (idx[:, None] < idx[None, :])  # [i, j]: i kills j

    def cond(state):
        decided, _ = state
        return ~jnp.all(decided)

    def body(state):
        decided, alive = state
        ready = jnp.all(~earlier | decided[:, None], axis=0)
        killed = jnp.any(earlier & (alive & decided)[:, None], axis=0)
        alive = jnp.where(ready & ~decided, valid & ~killed, alive)
        return decided | ready, alive

    _, alive = jax.lax.while_loop(
        cond, body, (jnp.zeros(C, bool), valid))
    return alive
