"""Stage-by-stage device timing of a match config on the current GPU.

Times the real code paths: stages come from build_stages with the default
warp dispatch, and the per-layer descent goes through descend_range
(including the alive-first sort and chunk skipping). Each stage is its
own jitted program, timed as the median of --iters calls ended by
block_until_ready after a warm-up call (compilation excluded); the last
line is the whole match as one program.

Usage: python tools/profile_stages.py [--images DIR] [flagship|many|test1|
       test4|test5|test6]   (flagship and many are seeded numpy scenes;
       the others read the reference's 'Test Images' directory)
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

IMG_DIR = None  # set by --images


def _load_case(name):
    import cv2
    import fastest_image_pattern_matching_tpu as fipm
    from fastest_image_pattern_matching_tpu.utils import scenes

    if name == "flagship":
        scene, templ, _ = scenes.flagship_scene(0)
        cfg = fipm.MatchConfig(**scenes.FLAGSHIP_CONFIG)
    elif name == "many":
        scene, templ, _ = scenes.many_targets_scene(0)
        cfg = fipm.MatchConfig(**scenes.MANY_TARGETS_CONFIG)
    elif name == "test1":
        scene = cv2.imread(f"{IMG_DIR}/Src9.bmp", cv2.IMREAD_GRAYSCALE)
        templ = cv2.imread(f"{IMG_DIR}/Dst9.bmp", cv2.IMREAD_GRAYSCALE)
        cfg = fipm.MatchConfig(max_pos=5, max_overlap=0.8, score=0.7,
                               tolerance_angle=180.0)
    elif name == "test4":
        scene = cv2.imread(f"{IMG_DIR}/Src3.bmp", cv2.IMREAD_GRAYSCALE)
        templ = cv2.imread(f"{IMG_DIR}/Dst3.bmp", cv2.IMREAD_GRAYSCALE)
        cfg = fipm.MatchConfig(max_pos=38, score=0.8, tolerance_angle=0.0,
                               min_reduce_area=256)
    elif name == "test5":
        scene = cv2.imread(f"{IMG_DIR}/Src4.bmp", cv2.IMREAD_GRAYSCALE)
        templ = cv2.imread(f"{IMG_DIR}/Dst4.bmp", cv2.IMREAD_GRAYSCALE)
        cfg = fipm.MatchConfig(max_pos=38, score=0.8, tolerance_angle=180.0,
                               min_reduce_area=256)
    elif name == "test6":
        scene = cv2.imread(f"{IMG_DIR}/Src6.jpg", cv2.IMREAD_GRAYSCALE)
        templ = cv2.imread(f"{IMG_DIR}/Dst6.bmp", cv2.IMREAD_GRAYSCALE)
        cfg = fipm.MatchConfig(max_pos=15, score=0.8, tolerance_angle=180.0,
                               min_reduce_area=256)
    else:
        raise SystemExit(f"unknown case {name}")
    return scene, templ, cfg


def profile_case(name="flagship", log=print, iters=10):
    import jax
    import jax.numpy as jnp
    import fastest_image_pattern_matching_tpu as fipm
    from fastest_image_pattern_matching_tpu.models.template_matcher import (
        _make_plan, _top_sweep_arrays, build_stages)
    from fastest_image_pattern_matching_tpu.ops.pyramid import build_pyramid

    def timeit(label, fn, *args):
        real = jax.jit(fn)
        out = jax.block_until_ready(real(*args))   # compile + warm-up
        ts = []
        for _ in range(iters):
            t0 = time.perf_counter()
            jax.block_until_ready(real(*args))
            ts.append((time.perf_counter() - t0) * 1000)
        log(f"  {label}: {float(np.median(ts)):.3f} ms")
        return out

    scene, templ, cfg = _load_case(name)
    pattern = fipm.learn_pattern(templ, cfg.min_reduce_area)
    plan = _make_plan(scene.shape, pattern, cfg)
    inv_mats, trans, valid_wh, angles_arr = _top_sweep_arrays(plan)
    stats = tuple((lv.mean, lv.norm, lv.inv_area, lv.result_equal1)
                  for lv in pattern.levels)
    st = build_stages(plan, stats)
    templs = tuple(jnp.asarray(lv.templ) for lv in pattern.levels)
    src = jnp.asarray(scene, jnp.float32)
    inv_j, trans_j = jnp.asarray(inv_mats), jnp.asarray(trans)
    vwh_j, ang_j = jnp.asarray(valid_wh), jnp.asarray(angles_arr)

    log(f"{name}: plan top={plan.top} stop={plan.stop} A={len(plan.angles)} "
        f"canvas={plan.canvas_hw} C={plan.c_max} K={plan.k_peaks} "
        f"k_ang={plan.k_ang} templ={plan.templ_shapes}")

    pyr = timeit("pyramid", lambda s: tuple(build_pyramid(s, plan.top)), src)
    vals, locs = timeit(
        "sweep (warp+ncc+peaks)",
        lambda s, im, vw: st.sweep_maps(s, templs[plan.top], im, vw),
        pyr[plan.top], inv_j, vwh_j)
    cand = timeit("select",
                  lambda v, l: st.select_candidates(v, l, trans_j, ang_j),
                  vals, locs)
    state = timeit("unrotate",
                   lambda c: (st.unrotate(c[0], c[1]),) + c[1:], cand)
    for l in range(plan.top - 1, plan.stop - 1, -1):
        state = timeit(
            f"descend layer {l} (templ {plan.templ_shapes[l]})",
            lambda p, s, ll=l: st.descend_range(p, templs, *s, ll, ll),
            tuple(pyr), state)
    scale = 1.0 if plan.stop == 0 else 2.0
    timeit("finalize (score sort + NMS)",
           lambda s: st.finalize(s[0] * scale, s[1], s[2], s[3]), state)
    timeit("end-to-end (single program)",
           lambda s: st.match_fn(s, templs, inv_j, trans_j, vwh_j, ang_j),
           src)


def main():
    global IMG_DIR
    ap = argparse.ArgumentParser(description="per-stage device timing")
    ap.add_argument("cases", nargs="*", default=["flagship"])
    ap.add_argument("--images", default=None,
                    help="the reference's 'Test Images' directory")
    args = ap.parse_args()
    IMG_DIR = args.images
    import jax
    if jax.default_backend() != "gpu":
        print("profile_stages: needs a GPU", file=sys.stderr)
        return 2
    from fastest_image_pattern_matching_tpu.utils.compile_cache import (
        enable_compile_cache)
    enable_compile_cache()
    for name in args.cases:
        profile_case(name)
    return 0


if __name__ == "__main__":
    sys.exit(main())
