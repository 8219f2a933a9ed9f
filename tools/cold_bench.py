"""Cold-start measurement: per suite config, a FRESH process's first
match call with a warm persistent compile cache — the cost a library
user pays on first call after a deployment prewarm
(tools/prewarm_cache.py).

Each (config, mode) runs in its own subprocess, one after another, so
only one process holds the GPU at a time; this parent process never
imports JAX. Run after prewarming.

Usage: python tools/cold_bench.py --images "<reference>/Test Images"
"""

import argparse
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHILD = r'''
import json, os, sys, time
t_imp0 = time.time()
import jax
repo, images, name, mode = sys.argv[1:5]
sys.path.insert(0, repo); sys.path.insert(0, os.path.join(repo, "tools"))
from fastest_image_pattern_matching_tpu.utils.compile_cache import (
    enable_compile_cache)
enable_compile_cache()
import jax.numpy as jnp
import cv2
import fastest_image_pattern_matching_tpu as fipm
import suite_bench
t_imp = time.time() - t_imp0
suite_bench.IMG_DIR = images
packs = os.path.join(repo, ".aot_packs")
if mode == "orb_pack":
    # Fresh-process ORB first match from the bundled-executable pack
    # (tools/orb_bench.py exports it; Src8 crop vs Dst8).
    src_full = cv2.imread(f"{images}/Src8.bmp", cv2.IMREAD_GRAYSCALE)
    tpl = cv2.imread(f"{images}/Dst8.bmp", cv2.IMREAD_GRAYSCALE)
    crop = src_full[215:480, 0:334]
    t0 = time.time()
    m = fipm.AotOrb.load(os.path.join(packs, "orb_Src8crop.npz"))
    t_load = time.time() - t0
    t0 = time.time()
    r = m.match(crop, tpl)
    first_ms = (time.time() - t0) * 1000
    print(json.dumps({"test": name, "mode": mode, "import_s": t_imp,
                      "pack_load_ms": t_load * 1000,
                      "first_match_ms": first_ms,
                      "found": int(r.is_matched)}))
    sys.exit(0)
row = [t for t in suite_bench.TESTS if t[0] == name][0]
_, s, d, kw, _refs, _expect, _note = row
tpl = cv2.imread(f"{images}/{d}", cv2.IMREAD_GRAYSCALE)
src = suite_bench._load_scene(s, tpl)
cfg = fipm.MatchConfig(**kw)
src_dev = jax.block_until_ready(jnp.asarray(src, jnp.float32))
if mode == "aot":
    # Deployment path: load the exported pack — zero tracing.
    t0 = time.time()
    m = fipm.AotMatcher.load(os.path.join(packs, f"{name}.npz"))
    t_load = time.time() - t0
    t0 = time.time()
    res = m.match(src_dev)
    first_ms = (time.time() - t0) * 1000
    extra = {"pack_load_ms": t_load * 1000}
else:
    pattern = fipm.learn_pattern(tpl, cfg.min_reduce_area)
    t0 = time.time()
    res = fipm.match(src_dev, pattern, cfg)
    first_ms = (time.time() - t0) * 1000
    extra = {}
print(json.dumps(dict({"test": name, "mode": mode, "import_s": t_imp,
                       "first_match_ms": first_ms, "found": len(res)},
                      **extra)))
'''

ALL_TESTS = ("Test1", "Test2", "Test3", "Test4", "Test5", "Test6", "Test7")


def _one_child(images, name, mode, timeout=900):
    try:
        out = subprocess.run(
            [sys.executable, "-c", CHILD, REPO, images, name, mode],
            capture_output=True, text=True, timeout=timeout, cwd=REPO)
        return json.loads(out.stdout.strip().splitlines()[-1])
    except Exception as e:
        return {"test": name, "mode": mode, "error": str(e)[:200]}


def run_cold(images, tests=ALL_TESTS, log=print, modes=("traced", "aot")):
    """One fresh process per (test, mode), run one after another."""
    rows = []
    for name in tests:
        for mode in modes:
            row = _one_child(images, name, mode)
            log(f"cold {name}/{mode}: {row}")
            rows.append(row)
    return rows


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description="fresh-process first match")
    ap.add_argument("--images", required=True,
                    help="the reference's 'Test Images' directory")
    args = ap.parse_args()

    def _log(m):
        print(m, file=sys.stderr, flush=True)
    rows = run_cold(args.images, log=_log)
    rows += run_cold(args.images, tests=("ORB",), modes=("orb_pack",),
                     log=_log)
    print(json.dumps({
        "cold": rows,
        "note": "first_match_ms = first match in a FRESH process with the "
                "persistent compile cache prewarmed (traced) or from an "
                "AOT pack (aot; pack_load_ms separate).",
    }, indent=1))
