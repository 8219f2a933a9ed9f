"""Record conformance goldens for the real Test Images pairs.

The reference has no automated tests; its README tables are the spec. We
record our implementation's (score, angle, x, y) lists on the available
real pairs as regression goldens (tests/goldens.json), asserted by
tests/test_conformance.py within tight tolerances. Run on CPU for
platform-independent numerics:

    python tools/record_goldens.py
"""

import json
import os
import sys

import jax

jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import fastest_image_pattern_matching_tpu as fipm
from fastest_image_pattern_matching_tpu.utils.imageio import load_gray

TI = "/root/reference/Test Images"

# (name, src, dst, config kwargs) — chosen to exercise the regimes of
# README Tests 1-7 on the pairs whose source images survive in the repo.
CASES = [
    ("src4_tol0_multi", f"{TI}/Src4.bmp", f"{TI}/Dst4.bmp",
     dict(max_pos=40, score=0.5, tolerance_angle=0.0, max_overlap=0.5,
          min_reduce_area=256)),
    ("src4_tol180", f"{TI}/Src4.bmp", f"{TI}/Dst4.bmp",
     dict(max_pos=5, score=0.8, tolerance_angle=180.0, max_overlap=0.1,
          min_reduce_area=256)),
    ("src3_tol180", f"{TI}/Src3.bmp", f"{TI}/Dst3.bmp",
     dict(max_pos=10, score=0.8, tolerance_angle=180.0, max_overlap=0.1,
          min_reduce_area=256)),
    ("src8_tol180", f"{TI}/Src8.bmp", f"{TI}/Dst8.bmp",
     dict(max_pos=3, score=0.5, tolerance_angle=180.0, max_overlap=0.1,
          min_reduce_area=256)),
    ("src9_tol180", f"{TI}/Src9.bmp", f"{TI}/Dst9.bmp",
     dict(max_pos=5, score=0.5, tolerance_angle=180.0, max_overlap=0.2,
          min_reduce_area=256)),
    ("src9_fastmode", f"{TI}/Src9.bmp", f"{TI}/Dst9.bmp",
     dict(max_pos=5, score=0.5, tolerance_angle=180.0, max_overlap=0.2,
          min_reduce_area=256, fast_mode=True)),
    ("src8_dualrange", f"{TI}/Src8.bmp", f"{TI}/Dst8.bmp",
     dict(max_pos=3, score=0.5, tolerance_ranges=(-30.0, -5.0, 10.0, 40.0),
          max_overlap=0.2, min_reduce_area=256)),
    # README Test1 parameters with score lowered to 0.7 (the README caption
    # says 0.8 but its own Result8 screenshot shows 4 matches at 0.70-0.76;
    # 0.7 keeps the cap-sensitive 0.764 matches above the final score
    # filter — the candidate-cap recall regression case).
    ("src9_test1", f"{TI}/Src9.bmp", f"{TI}/Dst9.bmp",
     dict(max_pos=5, max_overlap=0.8, score=0.7, tolerance_angle=180.0)),
    # --- round-5 widening (VERDICT r4 item 8): dual-range, bitwise_not,
    # fast_mode, and min_reduce_area 64/1024 across the surviving pairs
    # (reference ranges: README.md:59-71 + MatchToolDlg.cpp:108-117). ---
    ("src3_dualrange", f"{TI}/Src3.bmp", f"{TI}/Dst3.bmp",
     dict(max_pos=38, score=0.8, tolerance_ranges=(-10.0, 10.0, 170.0,
                                                   190.0),
          max_overlap=0.5, min_reduce_area=256)),
    ("src3_fastmode", f"{TI}/Src3.bmp", f"{TI}/Dst3.bmp",
     dict(max_pos=38, score=0.8, tolerance_angle=0.0, max_overlap=0.5,
          min_reduce_area=256, fast_mode=True)),
    ("src3_mra64", f"{TI}/Src3.bmp", f"{TI}/Dst3.bmp",
     dict(max_pos=38, score=0.8, tolerance_angle=0.0, max_overlap=0.5,
          min_reduce_area=64)),
    ("src3_mra1024", f"{TI}/Src3.bmp", f"{TI}/Dst3.bmp",
     dict(max_pos=38, score=0.8, tolerance_angle=0.0, max_overlap=0.5,
          min_reduce_area=1024)),
    ("src4_dualrange", f"{TI}/Src4.bmp", f"{TI}/Dst4.bmp",
     dict(max_pos=24, score=0.8, tolerance_ranges=(-40.0, -5.0, 10.0,
                                                   45.0),
          max_overlap=0.1, min_reduce_area=256)),
    ("src4_mra64", f"{TI}/Src4.bmp", f"{TI}/Dst4.bmp",
     dict(max_pos=5, score=0.8, tolerance_angle=180.0, max_overlap=0.1,
          min_reduce_area=64)),
    # bitwise_not (m_ckBitwiseNot): the inverted scene must reproduce the
    # plain src9_tol180 matches exactly (prep re-inverts the source).
    ("src9_bitnot", f"{TI}/Src9.bmp", f"{TI}/Dst9.bmp",
     dict(max_pos=5, score=0.5, tolerance_angle=180.0, max_overlap=0.2,
          min_reduce_area=256, bitwise_not=True), dict(invert_src=True)),
    ("src8_mra1024", f"{TI}/Src8.bmp", f"{TI}/Dst8.bmp",
     dict(max_pos=3, score=0.5, tolerance_angle=180.0, max_overlap=0.1,
          min_reduce_area=1024)),
    ("src8_fastmode", f"{TI}/Src8.bmp", f"{TI}/Dst8.bmp",
     dict(max_pos=3, score=0.5, tolerance_angle=180.0, max_overlap=0.1,
          min_reduce_area=256, fast_mode=True)),
    # The big-template regime (Test6 pair). Narrow sweep + fast_mode keep
    # the CPU test-suite replay affordable; the full-circle Test6 config
    # is covered on the GPU by tools/suite_bench.py.
    ("src6_narrow", f"{TI}/Src6.jpg", f"{TI}/Dst6.bmp",
     dict(max_pos=15, score=0.8, tolerance_angle=15.0, max_overlap=0.1,
          min_reduce_area=256, fast_mode=True)),
]


def main():
    import time
    out = {}
    for case in CASES:
        name, src_p, dst_p, kw = case[:4]
        extra = case[4] if len(case) > 4 else {}
        src = load_gray(src_p)
        if extra.get("invert_src"):
            src = 255 - src
        tpl = load_gray(dst_p)
        cfg = fipm.MatchConfig(**kw)
        pattern = fipm.learn_pattern(tpl, cfg.min_reduce_area)
        t0 = time.perf_counter()
        res = fipm.match(src, pattern, cfg)
        out[name] = {
            "src": os.path.basename(src_p), "dst": os.path.basename(dst_p),
            "config": kw, **extra,
            "matches": [[round(r.score, 5), round(r.angle, 4),
                         round(r.pos_x, 3), round(r.pos_y, 3)]
                        for r in res],
        }
        print(f"{name}: {len(res)} matches ({time.perf_counter()-t0:.1f}s);"
              f" best={out[name]['matches'][:1]}")
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tests", "goldens.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print("wrote", path)


if __name__ == "__main__":
    main()
