"""Pre-warm the persistent XLA compile cache for a deployment's configs.

A fresh process pays trace + compile on its first call per (shape,
config). This tool compiles every suite config and the flagship into the
persistent cache (utils/compile_cache.py) ahead of time, so a fresh
process's first match pays only cache deserialization. The cache key
includes the platform, so run it on the deployment machine.

Usage: python tools/prewarm_cache.py --images "<reference>/Test Images"
"""

import argparse
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tools"))

PACK_DIR = os.path.join(REPO, ".aot_packs")


def prewarm_suite(images, batch: int = 8, log=print,
                  export_packs: bool = False):
    """Compile the Test1-7 suite's single-frame AND batched programs (plus
    the flagship's) into the persistent cache.

    export_packs=True additionally writes an AOT pack per config into
    PACK_DIR (fipm.export_match_pack) and runs each pack's programs once
    so their (differently-keyed) executables are also cache-resident —
    the full deployment prewarm."""
    from fastest_image_pattern_matching_tpu.utils.compile_cache import (
        enable_compile_cache)
    enable_compile_cache()
    import cv2
    import jax.numpy as jnp
    import fastest_image_pattern_matching_tpu as fipm
    from fastest_image_pattern_matching_tpu.utils import scenes
    import suite_bench
    suite_bench.IMG_DIR = images

    if export_packs:
        os.makedirs(PACK_DIR, exist_ok=True)
    done = []
    for name, s, d, kw, _refs, _expect, _note in suite_bench.TESTS:
        tpl = cv2.imread(f"{images}/{d}", cv2.IMREAD_GRAYSCALE)
        src = suite_bench._load_scene(s, tpl) if tpl is not None else None
        if src is None or tpl is None:
            continue
        cfg = fipm.MatchConfig(**kw)
        pattern = fipm.learn_pattern(tpl, cfg.min_reduce_area)
        src_dev = jnp.asarray(src, jnp.float32)
        t0 = time.perf_counter()
        fipm.match(src_dev, pattern, cfg)
        t1 = time.perf_counter()
        stack = jnp.stack([src_dev] * batch)
        fipm.match_many(stack, pattern, cfg, batch_bucket=batch)
        t2 = time.perf_counter()
        msg = f"{name}: single {t1 - t0:.1f}s, batched {t2 - t1:.1f}s"
        if export_packs:
            path = os.path.join(PACK_DIR, f"{name}.npz")
            fipm.export_match_pack(path, pattern, cfg, src.shape,
                                   batch_sizes=(batch,),
                                   include_executables=True)
            m = fipm.AotMatcher.load(path)
            m.match(src_dev)          # compile the pack's programs into
            m.match_many(stack)       # the persistent cache
            t3 = time.perf_counter()
            msg += f", aot pack+warm {t3 - t2:.1f}s"
        log(msg)
        done.append(name)

    # The flagship (bench.py's headline config).
    scene, templ, _ = scenes.flagship_scene(0)
    pattern = fipm.learn_pattern(templ, scenes.FLAGSHIP_MIN_REDUCE_AREA)
    cfg = fipm.MatchConfig(**scenes.FLAGSHIP_CONFIG)
    scene_dev = jnp.asarray(scene, jnp.float32)
    t0 = time.perf_counter()
    fipm.match(scene_dev, pattern, cfg)
    fipm.match_many(jnp.stack([scene_dev] * 8), pattern, cfg,
                    batch_bucket=8)
    log(f"flagship: single+batched {time.perf_counter() - t0:.1f}s")
    done.append("flagship")
    return done


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description="prewarm the compile cache")
    ap.add_argument("--images", required=True,
                    help="the reference's 'Test Images' directory")
    ap.add_argument("--export-packs", action="store_true")
    a = ap.parse_args()
    prewarm_suite(a.images, export_packs=a.export_packs)
