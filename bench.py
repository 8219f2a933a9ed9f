"""Benchmark harness — prints ONE JSON line.

Headline metric: end-to-end latency of fipm.match on the reference's
flagship case (Src7/Dst7: 4024x3036 source, 762x521 template, 3 targets
at 0/+-120 degrees, tolerance 180, subpixel on — reference: 76 ms on an
i7-10700, README.md:45-55). Src7.bmp is not redistributable, so the scene
is rebuilt with numpy from a seed at the same shapes and parameters
(utils/scenes.py); the workload (angle count, pyramid depth, score-map
sizes) is the same.

Each timed call is a full fipm.match on a device-resident frame; match
returns host results, so the time includes the device work and the
readback. Also reported: the same call on a u8 host frame (upload
included) and the per-frame time of a batch of 8 through match_many.
Refuses to run without a GPU: a CPU number is not this metric.

vs_baseline = reference_ms / our_ms  (>1 means faster than reference).
"""

import json
import subprocess
import sys
import time

import numpy as np

REFERENCE_MS = 76.0  # README.md:45-55, i7-10700
ITERS = 20


def _median_ms(fn, iters=ITERS):
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        ts.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ts)), float(np.min(ts))


def main():
    import jax
    if jax.default_backend() != "gpu":
        print(f"bench: no GPU (backend {jax.default_backend()!r})",
              file=sys.stderr)
        return 2
    from fastest_image_pattern_matching_tpu.utils.compile_cache import (
        enable_compile_cache)
    enable_compile_cache()
    import jax.numpy as jnp
    import fastest_image_pattern_matching_tpu as fipm
    from fastest_image_pattern_matching_tpu.utils import scenes

    scene, templ, truth = scenes.flagship_scene(0)
    pattern = fipm.learn_pattern(templ, scenes.FLAGSHIP_MIN_REDUCE_AREA)
    cfg = fipm.MatchConfig(**scenes.FLAGSHIP_CONFIG)
    scene_dev = jax.block_until_ready(jnp.asarray(scene, jnp.float32))

    t0 = time.perf_counter()
    res = fipm.match(scene_dev, pattern, cfg)
    first_ms = (time.perf_counter() - t0) * 1e3
    errs = scenes.match_truth_errors(res, truth)
    if len(res) != 3 or max(e[0] for e in errs) > 2.0:
        print(json.dumps({"metric": "src7_flagship_e2e_ms", "value": -1.0,
                          "unit": "ms", "vs_baseline": 0.0,
                          "detail": {"error": "planted targets not found",
                                     "found": len(res)}}))
        return 1

    ms, ms_min = _median_ms(lambda: fipm.match(scene_dev, pattern, cfg))
    host_ms, _ = _median_ms(lambda: fipm.match(scene, pattern, cfg))
    batch = jax.block_until_ready(jnp.stack([scene_dev] * 8))
    fipm.match_many(batch, pattern, cfg)
    many_ms, _ = _median_ms(lambda: fipm.match_many(batch, pattern, cfg),
                            iters=5)
    d = jax.devices()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({
        "metric": "src7_flagship_e2e_ms",
        "value": ms,
        "unit": "ms",
        "vs_baseline": REFERENCE_MS / ms,
        "detail": {
            "device": {"platform": d[0].platform, "kind": d[0].device_kind,
                       "count": len(d), "nvidia_smi": smi},
            "targets_found": len(res),
            "max_center_err_px": max(e[0] for e in errs),
            "ms_min": ms_min,
            "first_call_ms": first_ms,
            "u8_host_frame_ms": host_ms,
            "match_many_8_ms_per_frame": many_ms / 8,
            "iters": ITERS,
            "reference_ms": REFERENCE_MS,
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
