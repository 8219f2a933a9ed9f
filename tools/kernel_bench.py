"""Time the matcher's device forms on the GPU at the deployments' shapes.

For each stage with more than one formulation (pyramid, warp, correlation
form and dtype) this times every form at the shapes the flagship and
many-target deployments run, plus a grid of shapes for the correlation
form that ncc_score_map's "auto" picks, and the end-to-end match of both
scenes. Each row is one JSON line on stdout and in --out.

    python tools/kernel_bench.py [--out chiprun_out/kernel_bench.jsonl]

Times are medians of --iters runs, each ended by block_until_ready, after
warm-up (compilation is excluded). Refuses to run without a GPU.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def _median_ms(fn, args, iters):
    import jax
    jax.block_until_ready(fn(*args))          # compile + warm-up
    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ts)), float(np.min(ts))


class Bench:
    def __init__(self, out_path, iters):
        self.out = open(out_path, "w") if out_path else None
        self.iters = iters

    def row(self, **kw):
        line = json.dumps(kw)
        print(line, flush=True)
        if self.out:
            self.out.write(line + "\n")
            self.out.flush()

    def time(self, group, name, fn, args, **extra):
        try:
            med, best = _median_ms(fn, args, self.iters)
            self.row(group=group, name=name, ms=med, ms_min=best, **extra)
        except Exception as e:  # a form that fails to compile is a finding
            self.row(group=group, name=name, error=repr(e)[:400], **extra)


def bench_pyramid(b, scene):
    import jax
    import jax.numpy as jnp
    from fastest_image_pattern_matching_tpu.ops import pyramid

    def chain(fn):
        def f(x):
            out = [x]
            for _ in range(6):
                out.append(fn(out[-1]))
            return out
        return jax.jit(f)

    x = jnp.asarray(scene, jnp.float32)
    for name in ("pyr_down",):
        if hasattr(pyramid, name):
            b.time("pyramid", name, chain(getattr(pyramid, name)), (x,),
                   shape=list(scene.shape), levels=6)


def _descent_shapes(plan):
    """(layer, roi_hw, templ_hw, n_rois) of one descent chunk per layer."""
    from fastest_image_pattern_matching_tpu.models import template_matcher
    out = []
    for l in range(plan.top - 1, plan.stop - 1, -1):
        th, tw = plan.templ_shapes[l]
        roi = (th + 6, tw + 6)
        cc = template_matcher._descend_chunk(roi, th * tw, plan.k_ang)
        out.append((l, roi, (th, tw), min(cc, plan.c_max) * plan.k_ang))
    return out


def bench_warp(b, plan, pyr):
    import jax
    import jax.numpy as jnp
    from fastest_image_pattern_matching_tpu.models import template_matcher
    from fastest_image_pattern_matching_tpu.ops import warp
    rng = np.random.default_rng(0)
    cases = []
    Hc, Wc = plan.canvas_hw
    inv_top = template_matcher._top_sweep_arrays(plan)[0]
    cases.append(("top-sweep", pyr[plan.top], inv_top, (Hc, Wc), 255.0))
    for l, roi, _, n in _descent_shapes(plan):
        sh, sw = pyr[l].shape
        c = (np.float32((sw - 1) / 2.0), np.float32((sh - 1) / 2.0))
        angs = jnp.asarray(rng.uniform(-180, 180, n), jnp.float32)
        shift = jnp.asarray(-rng.uniform([0, 0], [sw * 0.8, sh * 0.8],
                                         (n, 2)), jnp.float32)
        inv = np.asarray(warp.make_rotation_invmaps(c, angs, shift))
        cases.append((f"descent-L{l}", pyr[l], inv, roi, 0.0))
    for name, src, inv, hw, border in cases:
        src = jnp.asarray(src, jnp.float32)
        inv = jnp.asarray(inv)
        shape = dict(src=list(src.shape), batch=int(inv.shape[0]),
                     out=list(hw))
        fn = jax.jit(lambda s, i: warp.warp_affine_batch(
            s, i, hw, border, True))
        b.time("warp", f"{name} gather", fn, (src, inv), **shape)


def _corr_rows(b, tag, B, H, W, h, w, methods):
    import jax
    import jax.numpy as jnp
    from fastest_image_pattern_matching_tpu.ops import ncc
    rng = np.random.default_rng(1)
    canv = jnp.asarray(rng.integers(0, 256, (B, H, W)), jnp.float32)
    tpl = rng.integers(0, 256, (h, w)).astype(np.float32)
    mean = float(tpl.mean())
    norm = float(tpl.std() * math.sqrt(tpl.size))
    tj = jnp.asarray(tpl)
    shape = dict(shape=[B, H, W, h, w], auto=ncc.choose_method(B, H, W, h, w))
    for m in methods:
        for dt in (("f32",) if m == "fft" else ("bf16", "f32")):
            fn = jax.jit(lambda c, t, m=m, dt=dt: ncc.ncc_score_map(
                c, t, mean, norm, 1.0 / tpl.size, False, dt, m))
            b.time("corr", f"{tag} {m} {dt}", fn, (canv, tj), **shape)


def bench_corr(b, plans):
    fl, many = plans["flagship"], plans["many"]
    th, tw = fl.templ_shapes[fl.top]
    Hc, Wc = fl.canvas_hw
    rows = [("flagship-top", len(fl.angles), Hc, Wc, th, tw)]
    for l, roi, t, n in _descent_shapes(fl):
        rows.append((f"flagship-descent-L{l}", n, roi[0], roi[1], t[0], t[1]))
    rows.append(("test7-top", 1, 1824, 1824, 27, 27))
    for l, roi, t, n in _descent_shapes(many):
        rows.append((f"test7-descent-L{l}", n, roi[0], roi[1], t[0], t[1]))
    rows.append(("test4-top", 1, 155, 204, 13, 18))
    for tag, B, H, W, h, w in rows:
        Ho, Wo = H - h + 1, W - w + 1
        methods = ["conv", "fft"]
        if Ho * Wo <= 4096:
            methods.append("shiftmm")
        _corr_rows(b, tag, B, H, W, h, w, methods)


def bench_auto_grid(b):
    """Square maps x templates: the table ncc_score_map's auto is fit to."""
    for H in (128, 512, 1824):
        for h in (9, 27, 64):
            _corr_rows(b, f"grid H{H} h{h}", 1, H, H, h, h, ["conv", "fft"])
    for (h, w) in ((17, 24), (66, 96), (521, 762)):
        for d in (7, 32):
            _corr_rows(b, f"grid small-out {h}x{w} d{d}", 24, h + d - 1,
                       w + d - 1, h, w, ["conv", "fft", "shiftmm"])


def bench_e2e(b, scenes_by_name):
    import fastest_image_pattern_matching_tpu as fipm
    for name, (scene, tpl, cfg) in scenes_by_name.items():
        pat = fipm.learn_pattern(tpl, cfg.min_reduce_area)
        t0 = time.perf_counter()
        fipm.match(scene, pat, cfg)
        first = (time.perf_counter() - t0) * 1e3
        ts = []
        for _ in range(b.iters):
            t0 = time.perf_counter()
            fipm.match(scene, pat, cfg)
            ts.append((time.perf_counter() - t0) * 1e3)
        b.row(group="e2e", name=f"{name} fipm.match u8 host frame",
              ms=float(np.median(ts)), ms_min=float(np.min(ts)),
              first_call_ms=first)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="chiprun_out/kernel_bench.jsonl")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--only", default="pyramid,warp,corr,grid,e2e")
    args = ap.parse_args(argv)

    import jax
    if jax.default_backend() != "gpu":
        print("kernel_bench: needs a GPU", file=sys.stderr)
        return 2
    from fastest_image_pattern_matching_tpu.utils.compile_cache import (
        enable_compile_cache)
    enable_compile_cache()
    import jax.numpy as jnp
    import fastest_image_pattern_matching_tpu as fipm
    from fastest_image_pattern_matching_tpu.models import template_matcher
    from fastest_image_pattern_matching_tpu.ops.pyramid import build_pyramid
    from fastest_image_pattern_matching_tpu.utils import scenes

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    b = Bench(args.out, args.iters)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    d = jax.devices()[0]
    b.row(group="device", kind=d.device_kind, count=len(jax.devices()),
          nvidia_smi=smi, jax=jax.__version__)

    fs, ft, _ = scenes.flagship_scene(0)
    ms_, mt, _ = scenes.many_targets_scene(0)
    fcfg = fipm.MatchConfig(**scenes.FLAGSHIP_CONFIG)
    mcfg = fipm.MatchConfig(**scenes.MANY_TARGETS_CONFIG)
    plans = {
        "flagship": template_matcher._make_plan(
            fs.shape, fipm.learn_pattern(ft, fcfg.min_reduce_area), fcfg),
        "many": template_matcher._make_plan(
            ms_.shape, fipm.learn_pattern(mt, mcfg.min_reduce_area), mcfg),
    }
    only = set(args.only.split(","))
    if "pyramid" in only:
        bench_pyramid(b, fs)
    if "warp" in only:
        pyr = [np.asarray(p) for p in build_pyramid(
            jnp.asarray(fs, jnp.float32), plans["flagship"].top)]
        bench_warp(b, plans["flagship"], pyr)
    if "corr" in only:
        bench_corr(b, plans)
    if "grid" in only:
        bench_auto_grid(b)
    if "e2e" in only:
        bench_e2e(b, {"flagship": (fs, ft, fcfg), "many": (ms_, mt, mcfg)})
    return 0


if __name__ == "__main__":
    sys.exit(main())
