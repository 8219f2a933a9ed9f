"""Test1-7 suite benchmark — e2e ms per README performance test vs the
reference's published i7-10700 numbers (README.md:59-71; BASELINE.md).

Test -> image mapping recovered from the README's Result-image links
(Test1->Result8.jpg, Test2->Result1.jpg, Test3->Result2.jpg,
Test4->Result3.jpg, Test5->Result4.jpg, Test6->Result6.jpg,
Test7->Result9.jpg) and confirmed by inspecting the screenshots against
the surviving sources:
  Result8 = Src9 scene (e-clips + star washers)            -> Test1=Src9/Dst9
  Result1 = Src1 scene (7 screwdriver bits, rotated)       -> Test2=Src1/Dst1
  Result2 = Src2 scene (5 screwdriver bits, rotated)       -> Test3=Src2/Dst2
  Result3 = Src3 scene (SMD LED strip, 36 matches)         -> Test4=Src3/Dst3
  Result4 = Src4 scene (bearing, 24 rollers found)         -> Test5=Src4/Dst4
  Result6 = Src6 scene (metal parts grid, 15 matches)      -> Test6=Src6/Dst6
  Result9 = Src10 scene (~100 round washers)               -> Test7=Src10/Dst10

Src1/2/5/7/10 are stripped blobs (.MISSING_LARGE_BLOBS). Scenes for
Test2/Test3/Test7 are reconstructed synthetically at exact shapes with
REAL Dst instances planted at screenshot-derived geometry (the Src7
flagship runs the same way in bench.py):
  * Test2/Test3: scene size 2592x1944 recovered from the Result1/2
    screenshots — both are 4:3 like the overlays, and the known Dst
    widths (466/529 px) divided by their on-screen box widths give a
    consistent ~3.09x/3.07x scale (838*3.093=2592). 7 and 5 instances
    planted at the screenshot's center/angle estimates.
  * Test7: 3648x3648 with 100 planted real-Dst10 instances (the BlockMax
    many-target regime, BASELINE config 4).

Parameters are the README's where stated. Test2/Test3/Test5 have none
published; UI defaults (score 0.7/0.8, tol 180) are assumed and the
match COUNT is pinned to the golden screenshot (7 / 5 / 24) so the
configs are conformance-checked against the reference's own results.

Per row: ms, the median latency of fipm.match on a device-resident
frame (match returns host results, so device work and readback are
inside the timed call); first_call_ms (compile included); and
api_ms_per_frame, the per-frame latency of a batch through the public
fipm.match_many API. Needs a GPU: a CPU number is not these metrics.

Usage: python tools/suite_bench.py --images "<reference>/Test Images"
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

TESTS = [
    # name, src, dst, cfg-kwargs, reference ms (plain, simd), expected
    # found (None = don't pin), note
    ("Test1", "Src9.bmp", "Dst9.bmp",
     dict(max_pos=5, max_overlap=0.8, score=0.7, tolerance_angle=180.0),
     (164.0, 80.0), None,
     "caption says Score=0.8 but its own screenshot shows 4 "
     "matches at 0.70-0.76 (and the cv2 oracle agrees) -> UI-default 0.7"),
    ("Test2", "@synthetic_src1", "Dst1.bmp",
     dict(max_pos=10, score=0.7, tolerance_angle=180.0),
     (237.0, 175.0), 7,
     "Src1 stripped; synthetic 2592x1944 scene, 7 real-Dst1 instances at "
     "Result1.jpg geometry; params unpublished -> UI defaults, count "
     "pinned to screenshot"),
    ("Test3", "@synthetic_src2", "Dst2.bmp",
     dict(max_pos=10, score=0.7, tolerance_angle=180.0),
     (152.0, 100.0), 5,
     "Src2 stripped; synthetic 2592x1944 scene, 5 real-Dst2 instances at "
     "Result2.jpg geometry; params unpublished -> UI defaults, count "
     "pinned to screenshot"),
    ("Test4", "Src3.bmp", "Dst3.bmp",
     dict(max_pos=38, score=0.8, tolerance_angle=0.0, min_reduce_area=256),
     (21.0, None), None, ""),
    ("Test5", "Src4.bmp", "Dst4.bmp",
     dict(max_pos=38, score=0.8, tolerance_angle=180.0, min_reduce_area=256),
     (27.0, None), 24,
     "params unpublished; tol=180, count pinned to the 24 numbered "
     "matches in Result4.jpg"),
    ("Test6", "Src6.jpg", "Dst6.bmp",
     dict(max_pos=15, score=0.8, tolerance_angle=180.0, min_reduce_area=256),
     (1157.0, 657.0), None, ""),
    ("Test7", "@synthetic_src10", "Dst10.jpg",
     dict(max_pos=100, score=0.5, tolerance_angle=0.0, max_overlap=0.5,
          min_reduce_area=1024),
     (18.0, None), 100, "Src10 stripped; synthetic 3648x3648 scene, "
     "100 planted real-Dst10 instances"),
]

IMG_DIR = None  # set by --images

# (screenshot cx, cy, angle deg CCW) per match, read off the golden
# overlays; scaled by scene_w/screenshot_w at build time.
RESULT1_PLACEMENTS = [  # Result1.jpg, 838 px wide
    (315, 318, 33.0), (303, 122, 63.0), (383, 428, 63.0),
    (500, 245, 15.0), (555, 415, 22.0), (610, 225, -45.0),
    (632, 535, 7.0),
]
RESULT2_PLACEMENTS = [  # Result2.jpg, 843 px wide
    (165, 410, 20.0), (228, 190, 65.0), (350, 350, 20.0),
    (388, 190, 10.0), (500, 425, 15.0),
]


def _paste_rotated(scene, tpl, cx, cy, ang, rng):
    """Paste a rotated template instance into the scene (masked warp —
    the same construction bench.py uses for the flagship)."""
    import cv2
    th, tw = tpl.shape
    diag = int(np.ceil(np.hypot(th, tw))) + 4
    canvas = np.zeros((diag, diag), np.uint8)
    mask = np.zeros((diag, diag), np.uint8)
    y0, x0 = (diag - th) // 2, (diag - tw) // 2
    canvas[y0:y0 + th, x0:x0 + tw] = tpl
    mask[y0:y0 + th, x0:x0 + tw] = 255
    m = cv2.getRotationMatrix2D(((diag - 1) / 2, (diag - 1) / 2), ang, 1)
    rc = cv2.warpAffine(canvas, m, (diag, diag))
    rm = cv2.warpAffine(mask, m, (diag, diag), flags=cv2.INTER_NEAREST)
    ys = int(round(cy - (diag - 1) / 2))
    xs = int(round(cx - (diag - 1) / 2))
    reg = scene[max(ys, 0):ys + diag, max(xs, 0):xs + diag]
    rm2 = rm[:reg.shape[0], :reg.shape[1]]
    rc2 = rc[:reg.shape[0], :reg.shape[1]]
    reg[rm2 > 0] = rc2[rm2 > 0]


def _synthetic_bits_scene(tpl, placements, screenshot_w, seed):
    """2592x1944 dark-background scene with real-Dst bit instances at the
    golden screenshot's geometry (see module doc)."""
    rng = np.random.default_rng(seed)
    H, W = 1944, 2592
    scene = rng.integers(28, 52, size=(H, W), dtype=np.uint8)
    s = W / float(screenshot_w)
    for cx, cy, ang in placements:
        _paste_rotated(scene, tpl, cx * s, cy * s, ang, rng)
    return scene


def _synthetic_src10(tpl):
    """3648x3648 scene with 100 planted Dst10 instances on a bright
    background (Result9.jpg regime: round washers on white)."""
    rng = np.random.default_rng(7)
    H = W = 3648
    scene = np.full((H, W), 235, np.uint8)
    scene = (scene - rng.integers(0, 12, (H, W), dtype=np.uint8))
    th, tw = tpl.shape
    n = 0
    attempts = 0
    placed = []
    while n < 100 and attempts < 10000:
        attempts += 1
        y = int(rng.integers(40, H - th - 40))
        x = int(rng.integers(40, W - tw - 40))
        if any(abs(y - py) < th + 6 and abs(x - px) < tw + 6
               for py, px in placed):
            continue
        scene[y:y + th, x:x + tw] = tpl
        placed.append((y, x))
        n += 1
    return scene


def _load_scene(name, tpl):
    import cv2
    if name == "@synthetic_src10":
        return _synthetic_src10(tpl)
    if name == "@synthetic_src1":
        return _synthetic_bits_scene(tpl, RESULT1_PLACEMENTS, 838, 21)
    if name == "@synthetic_src2":
        return _synthetic_bits_scene(tpl, RESULT2_PLACEMENTS, 843, 22)
    return cv2.imread(f"{IMG_DIR}/{name}", cv2.IMREAD_GRAYSCALE)


def run_suite(iters=5, batch=8, log=print):
    import cv2
    import jax.numpy as jnp
    import fastest_image_pattern_matching_tpu as fipm

    rows = []
    for name, s, d, kw, (ref_ms, ref_simd_ms), expect, note in TESTS:
        tpl = cv2.imread(f"{IMG_DIR}/{d}", cv2.IMREAD_GRAYSCALE)
        src = _load_scene(s, tpl) if tpl is not None else None
        if src is None or tpl is None:
            log(f"{name}: SKIP (missing {s}/{d})")
            continue
        cfg = fipm.MatchConfig(**kw)
        pattern = fipm.learn_pattern(tpl, cfg.min_reduce_area)
        src_dev = jnp.asarray(src, jnp.float32)

        t0 = time.perf_counter()
        res = fipm.match(src_dev, pattern, cfg)  # compile + warmup
        first_call = (time.perf_counter() - t0) * 1000
        if expect is not None and len(res) != expect:
            log(f"{name}: CONFORMANCE FAIL found={len(res)} expected={expect}")
        times = []
        for _ in range(iters):
            ti = time.perf_counter()
            fipm.match(src_dev, pattern, cfg)
            times.append((time.perf_counter() - ti) * 1000)
        ms = float(np.median(times))

        # Per-frame through the public batched API: B device-resident
        # frames, one compiled dispatch.
        api_by_batch = {}
        for b in sorted({4, batch}):
            stack = jnp.stack([src_dev] * b)
            rb = fipm.match_many(stack, pattern, cfg)   # compile+warmup
            assert all(len(r) == len(res) for r in rb)
            api_times = []
            for _ in range(3):
                ti = time.perf_counter()
                fipm.match_many(stack, pattern, cfg)
                api_times.append((time.perf_counter() - ti) * 1000)
            api_by_batch[b] = float(np.median(api_times)) / b
        api_batch = min(api_by_batch, key=api_by_batch.get)
        api_ms = api_by_batch[api_batch]

        row = {
            "test": name, "src": s, "dst": d,
            "src_hw": list(src.shape), "dst_hw": list(tpl.shape),
            "found": len(res), "expected_found": expect,
            "top_scores": [r.score for r in res[:5]],
            "ms": ms, "first_call_ms": first_call,
            "api_ms_per_frame": api_ms, "api_batch": api_batch,
            "api_ms_by_batch": api_by_batch,
            "ref_ms": ref_ms, "ref_simd_ms": ref_simd_ms,
            "vs_ref": ref_ms / ms,
            "note": note,
        }
        rows.append(row)
        log(f"{name} [{s} {src.shape} / {d} {tpl.shape}]: {ms:.2f} ms "
            f"(ref {ref_ms:.0f} / simd {ref_simd_ms or '-'}) "
            f"api/frame={api_ms:.2f} found={len(res)} {note}")
    return rows


def main():
    global IMG_DIR
    import argparse
    ap = argparse.ArgumentParser(description="Test1-7 suite benchmark")
    ap.add_argument("--images", required=True,
                    help="the reference's 'Test Images' directory")
    IMG_DIR = ap.parse_args().images
    import jax
    if jax.default_backend() != "gpu":
        print("suite_bench: needs a GPU", file=sys.stderr)
        return 2
    from fastest_image_pattern_matching_tpu.utils.compile_cache import (
        enable_compile_cache)
    enable_compile_cache()
    rows = run_suite()
    print(json.dumps({"suite": rows}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
