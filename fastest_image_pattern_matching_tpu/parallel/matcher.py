"""Sharded batch matching over a ('data', 'angle') mesh.

Composition of the same stage functions as the single-chip program
(models.template_matcher.build_stages), re-wired with collectives:

  per device: sweep_maps over its LOCAL angle shard for its LOCAL images
      -> all_gather(peaks) over the 'angle' axis          (tiny: [A, K] * 3)
  per device: select_candidates (replicated, cheap) -> strided candidate
      shard -> descent of C/na candidates per device
      -> all_gather(survivors) over 'angle'               (tiny: [C] * 4)
  per device: finalize (NMS) for its LOCAL images
      -> results sharded over 'data'

The template pyramid and per-angle constants are replicated; cross-device
traffic is two tiny peak/candidate lists. Both the top-layer sweep AND
the pyramid descent scale with the angle axis; only finalize's NMS is
replicated within an angle group — deliberately: the greedy suppression
is sequential in score order (each round's decisions feed the next), so
sharding it would trade a stage whose cost scales with n_valid^2
(ops/nms.py two-axis chunk skipping) for per-round collectives on the
decision masks. This completes SURVEY §7 step 7: images and candidate
angles sharded data-parallel, per-shard work, all_gather merge.

Exactness vs single-chip: candidates are descended independently (same
per-candidate arithmetic), finalize orders candidates with a
position-based tie-break, and cfg.narrow_candidates narrows the GLOBAL
candidate set (all_gather + value-keyed top-cl mask, matching the
single-chip deterministic tie-break) rather than each shard locally —
so the partition cannot change the result.
Score thresholds and template stats are traced — score-only retunes and
same-shape templates reuse the compiled sharded program, like the
single-chip path. NMS overflow triggers the same uncapped re-dispatch.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..config import MatchConfig
from ..types import LearnedPattern
from ..models.template_matcher import (_Plan, _make_plan, _shared_plan,
                                       _stats_key, _thr_dev,
                                       _top_sweep_arrays,
                                       _traced_stats_tuple, build_stages)
from .mesh import ANGLE_AXIS, DATA_AXIS


def _pad_to(x: np.ndarray, n: int, fill=0):
    if x.shape[0] == n:
        return x
    pad = [(0, n - x.shape[0])] + [(0, 0)] * (x.ndim - 1)
    return np.pad(x, pad, constant_values=fill)


def build_sharded_match(plan: _Plan, ekey, mesh: Mesh):
    """Returns fn(srcs [B,H,W], templs, tstats, thr, inv_mats [A,2,3],
    trans, valid_wh, angles_arr) -> per-image result dict, sharded over
    'data'. `plan` should be the score-scrubbed _shared_plan; thresholds
    arrive via the traced thr array."""
    top = plan.top
    na = mesh.shape[ANGLE_AXIS]
    C = plan.c_max
    Cp = (C + na - 1) // na * na
    Cl = Cp // na

    from ..ops.pyramid import build_pyramid

    def per_device(srcs_l, templs, tstats, thr, inv_l, trans, valid_l,
                   angles_arr):
        # srcs_l: [Bl, H, W]; inv_l/valid_l: local angle shard.
        stats = tuple((t[0], t[1], t[2], e)
                      for t, e in zip(tstats, ekey))

        def narrow_hook(ptLT, ang, score, alive):
            """Global candidate narrowing under sharding: gather every
            shard's candidates, keep the global top-cl by the
            deterministic (score desc, y, x, angle) key — the same kept
            multiset as single-chip's physical truncation — and mask this
            shard's slice. Dropped candidates stay in place but dead
            (chunk-skipping makes them ~free)."""
            cl = max(2 * plan.cfg.max_pos + 4, 16)
            if Cp <= cl:
                return alive
            gpt = jax.lax.all_gather(ptLT, ANGLE_AXIS, axis=0, tiled=True)
            gang = jax.lax.all_gather(ang, ANGLE_AXIS, axis=0, tiled=True)
            gsc = jax.lax.all_gather(score, ANGLE_AXIS, axis=0, tiled=True)
            gal = jax.lax.all_gather(alive, ANGLE_AXIS, axis=0, tiled=True)
            key = jnp.where(gal, gsc, jnp.float32(-2.0))
            order = jnp.lexsort((gang, gpt[:, 0], gpt[:, 1], -key))
            keep = jnp.zeros((Cp,), bool).at[order[:cl]].set(True)
            ai_h = jax.lax.axis_index(ANGLE_AXIS)
            return alive & jax.lax.dynamic_slice_in_dim(
                keep, ai_h * Cl, Cl)

        st = build_stages(plan, stats, thr, narrow_hook=narrow_hook)
        ai = jax.lax.axis_index(ANGLE_AXIS)

        def one_image_sweep(src):
            pyr = build_pyramid(st.prep_src(src), top)
            vals, locs = st.sweep_maps(pyr[top], templs[top], inv_l, valid_l)
            return vals, locs, pyr

        # lax.map (not vmap): keeps per-image bodies unbatched (images per
        # device are few), bounding live memory to one image's sweep.
        vals, locs, pyr = jax.lax.map(one_image_sweep, srcs_l)
        # Merge peak lists across the angle axis (all_gather; axis 1 is
        # the angle dim of [Bl, a_local, K]).
        vals_g = jax.lax.all_gather(vals, ANGLE_AXIS, axis=1, tiled=True)
        locs_g = jax.lax.all_gather(locs, ANGLE_AXIS, axis=1, tiled=True)

        def shard_c(x, fill):
            """Strided candidate partition [C, ...] -> this device's
            [Cl, ...] (stride na keeps per-device alive density even —
            select_candidates returns score-sorted candidates)."""
            if Cp != C:
                pw = [(0, Cp - C)] + [(0, 0)] * (x.ndim - 1)
                x = jnp.pad(x, pw, constant_values=fill)
            xr = x.reshape((Cl, na) + x.shape[1:])
            return jax.lax.dynamic_index_in_dim(xr, ai, 1, keepdims=False)

        def unshard_c(x):
            """Gather per-device descent outputs and undo the stride
            interleave: global candidate g lived at (device g % na,
            slot g // na)."""
            g = jax.lax.all_gather(x, ANGLE_AXIS, axis=0, tiled=True)
            g = g.reshape((na, Cl) + x.shape[1:])
            g = jnp.moveaxis(g, 0, 1).reshape((Cp,) + x.shape[1:])
            return g[:C]

        def one_image_rest(vals_i, locs_i, pyr_i):
            pt, ang, score, alive = st.select_candidates(
                vals_i, locs_i, trans, angles_arr)
            pt_l = shard_c(pt, 0.0)
            ang_l = shard_c(ang, 0.0)
            score_l = shard_c(score, -1.0)
            alive_l = shard_c(alive, False)
            fpt, fang, score_l, alive_l = st.descend(
                pyr_i, templs, pt_l, ang_l, score_l, alive_l)
            return st.finalize(unshard_c(fpt), unshard_c(fang),
                               unshard_c(score_l), unshard_c(alive_l))

        return jax.lax.map(lambda t: one_image_rest(*t),
                           (vals_g, locs_g, pyr))

    fn = jax.shard_map(
        per_device, mesh=mesh,
        in_specs=(P(DATA_AXIS), P(), P(), P(), P(ANGLE_AXIS), P(),
                  P(ANGLE_AXIS), P()),
        out_specs=P(DATA_AXIS),
        check_vma=False)
    return jax.jit(fn)


@functools.lru_cache(maxsize=16)
def _compiled_sharded(plan: _Plan, ekey, mesh: Mesh):
    return build_sharded_match(plan, ekey, mesh)


def match_batch_sharded(
    srcs: np.ndarray,                  # [B, H, W] u8
    pattern: LearnedPattern,
    cfg: Optional[MatchConfig] = None,
    mesh: Optional[Mesh] = None,
) -> Dict[str, np.ndarray]:
    """Match one template against a batch of images, sharded over the mesh.

    B is padded to a multiple of the 'data' axis; the angle list is
    padded to a multiple of the 'angle' axis (padded angles are fully
    masked and produce no candidates). Returns stacked result arrays
    [B, max_pos, ...]."""
    plan, ekey, spans_processes, call_args, B = _prep_sharded_args(
        srcs, pattern, cfg, mesh)
    mesh = call_args[0]

    def dispatch(p: _Plan):
        fn = _compiled_sharded(_shared_plan(p), ekey, mesh)
        out = fn(*call_args[1:])
        if spans_processes:
            from jax.experimental import multihost_utils
            return {k: np.asarray(
                multihost_utils.process_allgather(v, tiled=True))[:B]
                for k, v in out.items()}
        return {k: np.asarray(v)[:B] for k, v in out.items()}

    out = dispatch(plan)
    overflow = out.pop("nms_overflow", None)
    if overflow is not None and np.any(overflow) \
            and plan.nms_cap < plan.c_max:
        # More above-threshold candidates than the NMS cap on some image —
        # re-dispatch with the cap lifted for the exact uncapped greedy
        # result (mirrors the single-chip path, template_matcher.py).
        plan_full = dataclasses.replace(plan, nms_cap=plan.c_max)
        out = dispatch(plan_full)
        out.pop("nms_overflow", None)
    return out


def _prep_sharded_args(srcs, pattern, cfg, mesh):
    """Shared input prep: plan + the exact argument tuple a compiled
    sharded program is called with (also used by tools/scaling_bench.py
    to lower the program for per-device cost analysis)."""
    from .mesh import make_mesh
    cfg = cfg or MatchConfig()
    mesh = mesh or make_mesh()
    srcs = np.asarray(srcs)
    if srcs.ndim == 4:
        from ..utils.imageio import ensure_gray
        srcs = ensure_gray(srcs)
    if srcs.ndim != 3:
        raise ValueError(f"srcs must be [B, H, W], got shape {srcs.shape}")
    if srcs.dtype != np.uint8:
        lo, hi = float(srcs.min()), float(srcs.max())
        if lo < 0.0 or hi > 255.0:
            raise ValueError(
                f"source values must lie in [0, 255] (8-bit contract, got "
                f"range [{lo}, {hi}]); rescale 16-bit imagery first")
    # Same guards as the single-chip path (Match() guards,
    # MatchToolDlg.cpp:774-781 via template_matcher._prepare).
    t0 = pattern.levels[0].templ
    if (t0.shape[0] > srcs.shape[1] and t0.shape[1] < srcs.shape[2]) or \
       (t0.shape[0] < srcs.shape[1] and t0.shape[1] > srcs.shape[2]):
        raise ValueError("template/source size relation unsupported")
    if t0.shape[0] * t0.shape[1] > srcs.shape[1] * srcs.shape[2]:
        raise ValueError("template larger than source")
    B = srcs.shape[0]
    nd, na = mesh.devices.shape

    plan = _make_plan(srcs.shape[1:], pattern, cfg)
    stats = tuple((lv.mean, lv.norm, lv.inv_area, lv.result_equal1)
                  for lv in pattern.levels)
    ekey = _stats_key(stats)
    # Multi-host meshes (jax.distributed): inputs must stay uncommitted
    # (host numpy, identical in every process) so pjit can shard them over
    # non-addressable devices; outputs are gathered with process_allgather.
    spans_processes = any(d.process_index != jax.process_index()
                          for d in mesh.devices.flat)
    as_dev = np.asarray if spans_processes else jnp.asarray
    if spans_processes:
        tstats = tuple((np.float32(s[0]), np.float32(s[1]), np.float32(s[2]))
                       for s in stats)
        thr = np.asarray(plan.layer_scores, np.float32)
    else:
        tstats = tuple(t[:3] for t in _traced_stats_tuple(stats))
        thr = _thr_dev(plan.layer_scores)
    templs = tuple(as_dev(lv.templ) for lv in pattern.levels)

    inv_mats, trans, valid_wh, angles_arr = _top_sweep_arrays(plan)
    A = inv_mats.shape[0]
    a_pad = (A + na - 1) // na * na
    # Pad angles with fully-masked entries (valid_wh 0 -> all scores -1);
    # trans/angles stay indexed by flat peak index, pad for consistency.
    inv_p = as_dev(_pad_to(inv_mats, a_pad))
    valid_p = as_dev(_pad_to(valid_wh, a_pad))
    trans_p = as_dev(_pad_to(trans, a_pad))
    angles_p = as_dev(_pad_to(angles_arr, a_pad))

    b_pad = (B + nd - 1) // nd * nd
    srcs_p = as_dev(_pad_to(srcs.astype(np.float32), b_pad))

    call_args = (mesh, srcs_p, templs, tstats, thr, inv_p, trans_p,
                 valid_p, angles_p)
    return plan, ekey, spans_processes, call_args, B
