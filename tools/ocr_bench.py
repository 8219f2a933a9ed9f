"""OCR / multi-template glyph benchmark — the reference's disabled
36-glyph M12 demo (MatchTool/MatchToolDlg.cpp:714-771) as a measured
serving workload.

Scene: a synthetic label plate with a known glyph string stamped from
the real M12 templates. Measures the batched MultiTemplateMatcher path
(match_patterns: same-shaped glyphs share one compiled program with the
source pyramid hoisted) against the per-glyph dispatch loop (the
reference's structure), and asserts the string is read back correctly.

Usage: python tools/ocr_bench.py --images "<reference>/Test Images"
"""

import glob
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

M12 = None  # <images>/M12, set by --images
TEXT = "M12X05"


def build_scene(glyphs, text=TEXT, hw=(360, 640), seed=4):
    rng = np.random.default_rng(seed)
    scene = rng.integers(150, 190, hw, dtype=np.uint8)
    x = 40
    placed = []
    for ch in text:
        g = glyphs[ch]
        y = 140 + int(rng.integers(-6, 7))
        scene[y:y + g.shape[0], x:x + g.shape[1]] = g
        placed.append((ch, x + (g.shape[1] - 1) / 2.0,
                       y + (g.shape[0] - 1) / 2.0))
        x += g.shape[1] + 14
    return scene, placed


def run_ocr_bench(log=print, iters=3):
    import cv2
    import jax.numpy as jnp
    import fastest_image_pattern_matching_tpu as fipm
    from fastest_image_pattern_matching_tpu.models.multi_template import (
        MultiTemplateMatcher)

    glyphs = {}
    for p in sorted(glob.glob(os.path.join(M12, "*.jpg"))):
        label = os.path.splitext(os.path.basename(p))[0]
        glyphs[label] = cv2.imread(p, cv2.IMREAD_GRAYSCALE)
    scene, placed = build_scene(glyphs)

    cfg = fipm.MatchConfig(max_pos=8, score=0.85, tolerance_angle=0.0,
                           min_reduce_area=256, max_overlap=0.4)
    # min_reduce_area 256 (the UI default the reference demo ran with):
    # 64 pyramids a 52x34 glyph down to 7x5, where the single-angle
    # candidate list (max_pos + 5, reference parity) starves before the
    # true peak on a cluttered scene — the reference misses identically.
    m = MultiTemplateMatcher(cfg)
    for label, g in glyphs.items():
        m.learn(label, g)
    n_glyphs = len(m.patterns)

    from fastest_image_pattern_matching_tpu.models.multi_template import (
        read_string as _read)

    def read_string(matches):
        return _read(matches, cfg.score)

    times = {}
    reads = {}
    for mode, batched in (("batched", True), ("per_glyph", False)):
        res = m.match_all(scene, batched=batched)     # compile + warm
        reads[mode] = read_string(res)
        ts = []
        for i in range(1, iters + 1):
            sc = np.clip(scene.astype(np.int32) + i, 0, 255).astype(
                np.uint8)
            t0 = time.perf_counter()
            r = m.match_all(sc, batched=batched)
            ts.append((time.perf_counter() - t0) * 1000)
        times[mode] = sorted(ts)[len(ts) // 2]
        log(f"{mode}: {times[mode]:.1f} ms, read={reads[mode]!r}")

    out = {
        "metric": "ocr_m12_glyphs",
        "n_glyphs": n_glyphs,
        "scene_hw": list(scene.shape),
        "expected_text": TEXT,
        "read_batched": reads["batched"],
        "read_per_glyph": reads["per_glyph"],
        "batched_ms": round(times["batched"], 1),
        "per_glyph_ms": round(times["per_glyph"], 1),
        "speedup": round(times["per_glyph"] / times["batched"], 2),
        "ok": bool(reads["batched"] == TEXT),
        "note": "reference analogue: the disabled per-glyph Execute loop "
                "(MatchToolDlg.cpp:714-771); batched = match_patterns "
                "shape-grouped single-dispatch path",
    }
    return out


def main():
    global M12
    import argparse
    ap = argparse.ArgumentParser(description="M12 glyph OCR benchmark")
    ap.add_argument("--images", required=True,
                    help="the reference's 'Test Images' directory")
    M12 = os.path.join(ap.parse_args().images, "M12")
    from fastest_image_pattern_matching_tpu.utils.compile_cache import (
        enable_compile_cache)
    enable_compile_cache()
    out = run_ocr_bench()
    print(json.dumps(out))
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
