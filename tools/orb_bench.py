"""ORB path timing on the GPU — the analogue of the reference's per-stage
ms printout (ORBFeatureMatcher.cpp:46-47 detect, :62-64 match, :111-113
RANSAC, :152-154 inliers).

Stages are measured as pipeline prefixes — each prefix jitted as one
program, timed as the median of calls ended by block_until_ready,
consecutive prefixes subtracted. The end-to-end number is what a
deployment pays; prefix deltas attribute it.

Output: one JSON object.
Usage: python tools/orb_bench.py --images "<reference>/Test Images"
"""

import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def run_orb_bench(images, log=print):
    import cv2
    import jax
    import jax.numpy as jnp
    from fastest_image_pattern_matching_tpu.models.orb import (
        ORBConfig, detect_and_describe, hamming_match, orb_match,
        ransac_homography)

    src_full = cv2.imread(f"{images}/Src8.bmp", cv2.IMREAD_GRAYSCALE)
    tpl = cv2.imread(f"{images}/Dst8.bmp", cv2.IMREAD_GRAYSCALE)
    crop = src_full[215:480, 0:334]   # single-instance region (see
    # tests/test_orb_cv2_parity.py) — the well-posed one-homography case
    cfg = ORBConfig()

    # End-to-end (host orchestration incl. several dispatches).
    res = orb_match(crop, tpl, cfg)
    e2e = []
    for _ in range(5):
        t0 = time.perf_counter()
        orb_match(crop, tpl, cfg)
        e2e.append((time.perf_counter() - t0) * 1000)
    e2e_ms = float(np.median(e2e))

    # Pipeline prefixes, each as one jitted program over the source image
    # (the template side is constant — folded in where needed).
    pt, dt_desc, vt = detect_and_describe(tpl, cfg)

    def p1_detect(img):
        ps, ds, vs = detect_and_describe(img, cfg)
        return jnp.sum(ps) + jnp.sum(ds)

    def p2_match(img):
        ps, ds, vs = detect_and_describe(img, cfg)
        ti, dist = hamming_match(ds, vs, dt_desc, vt)
        return jnp.sum(ti) + jnp.sum(jnp.where(jnp.isfinite(dist), dist, 0))

    def p3_ransac(img):
        ps, ds, vs = detect_and_describe(img, cfg)
        ti, dist = hamming_match(ds, vs, dt_desc, vt)
        N = min(cfg.max_good_matches, dist.shape[0])
        neg = jnp.where(jnp.isfinite(dist), -dist, -jnp.inf)
        _, order = jax.lax.top_k(neg, N)
        H, mask = ransac_homography(ps[order], pt[ti[order]],
                                    jnp.isfinite(dist[order]),
                                    cfg.ransac_threshold, cfg.ransac_iters)
        return jnp.sum(H) + jnp.sum(mask)

    # detect_and_describe builds the image pyramid in python over jax ops —
    # jit the whole prefix so each is ONE program.
    prefixes = {"detect": p1_detect, "match": p2_match, "ransac": p3_ransac}
    ms = {}
    spread = {}
    for name, fn in prefixes.items():
        jf = jax.jit(fn)
        img0 = jnp.asarray(crop, jnp.float32)
        jax.block_until_ready(jf(img0))  # compile + warm
        ts = []
        for _ in range(7):
            t0 = time.perf_counter()
            jax.block_until_ready(jf(img0))
            ts.append((time.perf_counter() - t0) * 1000)
        ts.sort()
        ms[name] = ts[len(ts) // 2]
        spread[name] = ts[-2] - ts[1]
        log(f"prefix {name}: {ms[name]:.1f} ms (spread {spread[name]:.1f})")

    # Two-stage attribution (round-3's three-way split put the tiny
    # Hamming stage below prefix-subtraction noise and reported a
    # negative time; the match+RANSAC tail is one honest stage).
    noise = round(max(spread.values()), 1)
    out = {
        "metric": "orb_stage_timing",
        "image_hw": list(crop.shape),
        "template_hw": list(tpl.shape),
        "e2e_ms": round(e2e_ms, 1),
        "prefix_ms": {k: round(v, 1) for k, v in ms.items()},
        "prefix_noise_ms": noise,
        "stage_ms": {
            "detect_describe_both": round(ms["detect"], 1),
            "match_plus_ransac": round(
                max(ms["ransac"] - ms["detect"], 0.0), 1),
        },
        "is_matched": bool(res.is_matched),
        "num_inliers": int(res.num_inliers),
        "reference_note": "reference prints detect/match/RANSAC/inlier ms "
                          "to stdout (ORBFeatureMatcher.cpp:46-64,111-113); "
                          "no absolute numbers published to compare against",
    }

    # AOT ORB pack serving (same-process export/load/match timings;
    # fresh-process cold start is tools/cold_bench.py's job).
    from fastest_image_pattern_matching_tpu.aot import AotOrb, export_orb_pack
    pack = os.path.join(REPO, ".aot_packs", "orb_Src8crop.npz")
    os.makedirs(os.path.dirname(pack), exist_ok=True)
    t0 = time.perf_counter()
    export_orb_pack(pack, cfg, crop.shape, tpl.shape,
                    include_executables=True, log=log)
    exp_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    m = AotOrb.load(pack)
    load_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    r2 = m.match(crop, tpl)
    first_ms = (time.perf_counter() - t0) * 1e3
    assert r2.is_matched == res.is_matched
    out["aot_pack"] = {
        "export_s": round(exp_s, 2),
        "load_ms": round(load_ms, 1),
        "first_match_ms_same_process": round(first_ms, 1),
        "pack_path": pack,
    }
    log(f"orb pack: export {exp_s:.1f}s load {load_ms:.0f}ms "
        f"first match {first_ms:.0f}ms")
    return out


def main():
    import argparse
    ap = argparse.ArgumentParser(description="ORB stage timing")
    ap.add_argument("--images", required=True,
                    help="the reference's 'Test Images' directory")
    images = ap.parse_args().images
    from fastest_image_pattern_matching_tpu.utils.compile_cache import (
        enable_compile_cache)
    enable_compile_cache()
    out = run_orb_bench(images)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
