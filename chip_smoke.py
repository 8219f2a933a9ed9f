#!/usr/bin/env python3
"""Smoke test of the matcher on one NVIDIA GPU.

Drives the public entry points (learn_pattern, match, match_many,
AotMatcher, orb_match) at full size on seeded numpy scenes and checks
every correlation form and the warp against plain references:

  1. device       the backend is a GPU (no CPU fallback)
  2. parity       pyr_down vs an integer numpy cv::pyrDown; every
                  ncc_score_map form and dtype vs a float64 numpy NCC;
                  the warp vs the same call on the CPU device
  3. flagship     a Src7-shaped scene through match and match_many,
                  against the planted truth and the CPU device
  4. many         a Test7-shaped scene (100 targets), the same checks
  5. aot, orb     an exported pack's result equals phase 3's; orb_match
                  vs the CPU device
  6. the last line is {"ok": true, "device": {...}}

    python chip_smoke.py               # one GPU, phases 1-6
    python chip_smoke.py --four-cards  # only the sharded paths on 4 GPUs

Exits non-zero, without the last line, when JAX finds no GPU or any
check fails.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np

FAILURES = []


def log(msg: str) -> None:
    print(msg, flush=True)


def check(name: str, ok: bool, detail: str = "") -> None:
    log(f"  [{'ok' if ok else 'FAIL'}] {name} {detail}")
    if not ok:
        FAILURES.append(name)


def run_phase(name, fn, *args):
    """Run one phase; a phase that raises is a failure (traceback shown)."""
    t0 = time.perf_counter()
    log(f"== phase {name}")
    try:
        out = fn(*args)
    except Exception:  # reported, counted, and fails the run below
        traceback.print_exc(file=sys.stdout)
        FAILURES.append(f"{name}: exception")
        out = None
    log(f"== phase {name}: {time.perf_counter() - t0:.1f} s")
    return out


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip()


# ---------------------------------------------------------------- references

def pyr_down_reference(img: np.ndarray) -> np.ndarray:
    """cv::pyrDown on u8 in integer arithmetic: 5-tap [1 4 6 4 1]
    separable sum over a BORDER_REFLECT_101 pad, stride 2,
    (sum + 128) >> 8."""
    x = np.pad(img.astype(np.int64), 2, mode="reflect")
    k = (1, 4, 6, 4, 1)
    h, w = img.shape
    oh, ow = (h + 1) // 2, (w + 1) // 2
    rows = sum(k[i] * x[i:i + 2 * oh - 1:2, :] for i in range(5))
    out = sum(k[j] * rows[:, j:j + 2 * ow - 1:2] for j in range(5))
    return ((out + 128) >> 8).astype(np.float32)


def _window_sums(x: np.ndarray, h: int, w: int) -> np.ndarray:
    c = np.cumsum(np.cumsum(x, axis=-2), axis=-1)
    c = np.pad(c, [(0, 0)] * (x.ndim - 2) + [(1, 0), (1, 0)])
    return (c[..., h:, w:] - c[..., :-h, w:] - c[..., h:, :-w]
            + c[..., :-h, :-w])


def ncc_reference(canv: np.ndarray, templ: np.ndarray) -> np.ndarray:
    """TM_CCOEFF_NORMED in float64 with the reference's guards
    (MatchToolDlg.cpp:1329-1400), independent of ops/ncc.py."""
    c = canv.astype(np.float64)
    t = templ.astype(np.float64)
    B, H, W = c.shape
    h, w = t.shape
    Ho, Wo = H - h + 1, W - w + 1
    tz = t - t.mean()
    num = np.zeros((B, Ho, Wo))
    if Ho * Wo < h * w:
        for dy in range(Ho):
            for dx in range(Wo):
                num[:, dy, dx] = np.einsum(
                    "bij,ij->b", c[:, dy:dy + h, dx:dx + w], tz)
    else:
        for dy in range(h):
            for dx in range(w):
                num += c[:, dy:dy + Ho, dx:dx + Wo] * tz[dy, dx]
    area = h * w
    s1 = _window_sums(c, h, w)
    s2 = _window_sums(c * c, h, w)
    diff2 = np.maximum(s2 - s1 * s1 / area, 0.0)
    tnorm = np.sqrt(np.mean(tz * tz)) * np.sqrt(area)
    cutoff = np.minimum(0.5, 10.0 * 1.1920929e-07 * s2)
    den = np.where(diff2 <= cutoff, 0.0, np.sqrt(diff2) * tnorm)
    safe = np.maximum(den, 1e-30)
    return np.where(np.abs(num) < den, num / safe,
                    np.where(np.abs(num) < den * 1.125, np.sign(num), 0.0))


# Largest difference between two devices' unquantized warps allowed at a
# pixel whose rounded values differ. The GPU computes level-0 sample
# coordinates near 4000 px a few ulps away from the CPU (fused
# multiply-adds), which moved a steep edge's value by at most 0.055 on an
# H100; a planted sub-pixel sampling fault reads higher (PERF.md).
WARP_UNQ_BOUND = 0.1


def quantized_parity(got, ref, ref_unq, got_unq=None, bound=WARP_UNQ_BOUND):
    """Quantized warps agree except at .5 rounding boundaries: every
    mismatch is +-1, rare (< 1e-3 of pixels) and at a boundary.

    Without got_unq, "at a boundary" means ref_unq lies within 1e-2 of
    X.5. With got_unq (the other device's unquantized warp) it means the
    two unquantized values differ by less than `bound` and each rounds to
    its own device's output."""
    d = got - ref
    bad = d != 0
    frac_bad = float(bad.mean())
    ok = np.abs(d).max(initial=0) <= 1 and frac_bad < 1e-3
    if bad.any() and got_unq is None:
        frac = np.abs(ref_unq[bad] - np.floor(ref_unq[bad]) - 0.5)
        ok = ok and float(frac.max()) < 1e-2
    elif bad.any():
        g, r = got_unq[bad], ref_unq[bad]
        ok = (ok and bool(np.all(np.abs(g - r) < bound))
              and bool(np.all(np.round(g) == got[bad]))
              and bool(np.all(np.round(r) == ref[bad])))
    return ok, frac_bad


# ---------------------------------------------------------------- phases

def phase_device():
    import jax
    devs = jax.devices()
    log(f"  backend={jax.default_backend()} kind={devs[0].device_kind} "
        f"count={len(devs)}")
    log(f"  nvidia-smi: {nvidia_smi_line()}")


def _plans():
    """Match plans of the two deployments (host-side shapes only)."""
    import fastest_image_pattern_matching_tpu as fipm
    from fastest_image_pattern_matching_tpu.models import template_matcher
    from fastest_image_pattern_matching_tpu.utils import scenes
    out = {}
    for name, build, cfg_kw in [
            ("flagship", scenes.flagship_scene, scenes.FLAGSHIP_CONFIG),
            ("many", scenes.many_targets_scene, scenes.MANY_TARGETS_CONFIG)]:
        scene, tpl, truth = build(0)
        cfg = fipm.MatchConfig(**cfg_kw)
        pat = fipm.learn_pattern(tpl, cfg.min_reduce_area)
        plan = template_matcher._make_plan(scene.shape, pat, cfg)
        out[name] = dict(scene=scene, tpl=tpl, truth=truth, cfg=cfg,
                         pattern=pat, plan=plan)
    return out


def phase_parity(cases):
    import jax
    import jax.numpy as jnp
    from fastest_image_pattern_matching_tpu.models import template_matcher
    from fastest_image_pattern_matching_tpu.ops import ncc, pyramid, warp
    cpu = jax.devices("cpu")[0]
    rng = np.random.default_rng(1)

    # Pyramid: the full 7-level pyramid of a 3036x4024 frame, bit exact.
    img = cases["flagship"]["scene"]
    ref = img.astype(np.float32)
    got = jnp.asarray(img, jnp.float32)
    exact = True
    for _ in range(6):
        ref = pyr_down_reference(ref.astype(np.uint8))
        got = pyramid.pyr_down(got)
        exact &= np.array_equal(np.asarray(got), ref)
    check("pyr_down 7 levels of 3036x4024 bit-exact", bool(exact))

    # Correlation forms vs float64 NCC at the shapes the matcher runs.
    fl = cases["flagship"]["plan"]
    top = fl.top
    th, tw = fl.templ_shapes[top]
    Hc, Wc = fl.canvas_hw
    n_ang = min(len(fl.angles), max(
        1, template_matcher._CHUNK_BUDGET_ELEMS // (Hc * Wc * 4)))
    l0h, l0w = fl.templ_shapes[0]
    shapes = {
        # name: (canvases [B, H, W], template [h, w], methods)
        "flagship-top": ((n_ang, Hc, Wc), (th, tw), ("conv", "fft", "auto")),
        "test7-top": ((1, 1824, 1824), (27, 27), ("conv", "fft", "auto")),
        "flagship-descent": ((24, l0h + 6, l0w + 6), (l0h, l0w),
                             ("shiftmm", "conv", "auto")),
        "test7-descent": ((32, 60, 60), (54, 54), ("shiftmm", "conv", "auto")),
    }
    for sname, (cshape, tshape, methods) in shapes.items():
        canv = rng.integers(0, 256, cshape).astype(np.float32)
        tpl = rng.integers(0, 256, tshape).astype(np.float32)
        want = ncc_reference(canv, tpl)
        area = tpl.size
        mean = float(np.mean(tpl, dtype=np.float64))
        norm = float(np.sqrt(np.mean((tpl - mean) ** 2.0)) * np.sqrt(area))
        args = (jnp.asarray(canv), jnp.asarray(tpl), mean, norm,
                1.0 / area, False)
        for method in methods:
            dtypes = ("f32",) if method == "fft" else ("bf16", "f32")
            for dt in dtypes:
                fn = jax.jit(lambda c, t, dt=dt, m=method: ncc.ncc_score_map(
                    c, t, *args[2:], dt, m))
                got = np.asarray(fn(*args[:2]))
                err = float(np.abs(got - want).max())
                label = resolved = method
                if method == "auto":
                    resolved = ncc.choose_method(*cshape, *tshape)
                    label = f"auto={resolved}"
                tol = 1e-5 if resolved == "fft" else 2e-6
                check(f"ncc {sname} {cshape}x{tshape} {label} {dt}",
                      err <= tol, f"max|err|={err:.3g} (tol {tol:g})")

    # Warp: the descent ROI batch and the top sweep, vs the CPU device.
    src0 = jnp.asarray(img, jnp.float32)
    sh, sw = img.shape
    center = (np.float32((sw - 1) / 2.0), np.float32((sh - 1) / 2.0))
    pts = rng.uniform([400, 400], [3000, 2200], (8, 2)).astype(np.float32)
    angs = np.repeat(rng.uniform(-180, 180, 8), 3).astype(np.float32)
    angs += np.tile(np.float32([-0.1, 0.0, 0.1]), 8)
    p_rep = np.repeat(pts, 3, axis=0)
    lt = warp.rotate_pt_jnp(jnp.asarray(p_rep), jnp.asarray(center),
                            jnp.asarray(np.deg2rad(angs)))
    inv_d = warp.make_rotation_invmaps(center, jnp.asarray(angs), -(lt - 3.0))
    inv_top = template_matcher._top_sweep_arrays(fl)[0][:n_ang]
    src_top = cases["flagship"]["pyr_top"]
    for wname, s, inv, hw, border in [
            ("descent", src0, np.asarray(inv_d), (l0h + 6, l0w + 6), 0.0),
            ("top-sweep", jnp.asarray(src_top), inv_top, (Hc, Wc),
             float(fl.border_color))]:
        def wf(s_, i_, q):
            return warp.warp_affine_batch(s_, i_, hw, border, quantize=q)
        got, got_unq = (np.asarray(jax.jit(wf, static_argnums=2)(
            s, jnp.asarray(inv), q)) for q in (True, False))
        with jax.default_device(cpu):
            s_c = jax.device_put(np.asarray(s), cpu)
            i_c = jax.device_put(np.asarray(inv), cpu)
            ref, ref_unq = (np.asarray(jax.jit(wf, static_argnums=2)(
                s_c, i_c, q)) for q in (True, False))
        ok, frac = quantized_parity(got, ref, ref_unq, got_unq)
        check(f"warp {wname} {got.shape} vs CPU", ok,
              f"mismatch fraction {frac:.2g}, unquantized "
              f"max|diff| {np.abs(got_unq - ref_unq).max():.3g}")


def _compare(name, got, ref, truth=None):
    """Results vs planted truth (<= 2 px, <= 0.5 deg) and vs the CPU
    device (same count and order, score 1e-4, xy 0.05 px, angle 0.01).

    "Same order" is up to ties: results whose scores agree within the
    score tolerance (100 identical targets all score 1.0) are ordered by
    last-ulp differences of the float32 epilogue, which differ between
    devices. Each GPU result is paired with the CPU result at the same
    position, and the pairing must keep the score order up to 1e-4."""
    from fastest_image_pattern_matching_tpu.utils import scenes
    if truth is not None:
        errs = np.array(scenes.match_truth_errors(got, truth))
        check(f"{name} vs truth ({len(truth)} targets)",
              len(got) == len(truth) and bool(np.all(errs[:, 0] <= 2.0))
              and bool(np.all(errs[:, 1] <= 0.5)),
              f"found={len(got)} max px={errs[:, 0].max():.3f} "
              f"max deg={errs[:, 1].max():.3f}")
    same = len(got) == len(ref)
    ds = dx = da = 0.0
    if same and got:
        rc = np.array([r.center for r in ref])
        pair = [int(np.argmin(np.hypot(*(rc - g.center).T))) for g in got]
        same = sorted(pair) == list(range(len(ref)))
        paired = [ref[j].score for j in pair]
        same = same and all(b <= a + 1e-4 for a, b in zip(paired, paired[1:]))
        for g, j in zip(got, pair):
            r = ref[j]
            ds = max(ds, abs(g.score - r.score))
            dx = max(dx, abs(g.center[0] - r.center[0]),
                     abs(g.center[1] - r.center[1]))
            da = max(da, abs((g.angle - r.angle + 180.0) % 360.0 - 180.0))
    check(f"{name} vs CPU device", same and ds <= 1e-4 and dx <= 0.05
          and da <= 0.01, f"n={len(got)}/{len(ref)} |dscore|={ds:.2g} "
          f"|dxy|={dx:.3g} |dangle|={da:.3g}")


def _on_cpu(fn, *args):
    import jax
    with jax.default_device(jax.devices("cpu")[0]):
        return fn(*args)


def phase_flagship(case):
    import fastest_image_pattern_matching_tpu as fipm
    scene, truth, cfg = case["scene"], case["truth"], case["cfg"]
    pat = case["pattern"]
    t0 = time.perf_counter()
    res = fipm.match(scene, pat, cfg)
    log(f"  match (first call, compile included): "
        f"{time.perf_counter() - t0:.2f} s")
    pat_cpu = _on_cpu(fipm.learn_pattern, case["tpl"], cfg.min_reduce_area)
    ref = _on_cpu(fipm.match, scene, pat_cpu, cfg)
    _compare("flagship match", res, ref, truth)

    shifts = [(0, 0), (7, -5), (-11, 13), (3, 21)]
    frames = np.stack([np.roll(scene, s, axis=(0, 1)) for s in shifts])
    many = fipm.match_many(frames, pat, cfg)
    many_cpu = _on_cpu(fipm.match_many, frames, pat_cpu, cfg)
    for i, (dy, dx) in enumerate(shifts):
        tr = [(x + dx, y + dy, a) for x, y, a in truth]
        _compare(f"flagship match_many[{i}]", many[i], many_cpu[i], tr)
    return res


def phase_many(case):
    import fastest_image_pattern_matching_tpu as fipm
    scene, truth, cfg = case["scene"], case["truth"], case["cfg"]
    t0 = time.perf_counter()
    res = fipm.match(scene, case["pattern"], cfg)
    log(f"  match (first call, compile included): "
        f"{time.perf_counter() - t0:.2f} s")
    pat_cpu = _on_cpu(fipm.learn_pattern, case["tpl"], cfg.min_reduce_area)
    ref = _on_cpu(fipm.match, scene, pat_cpu, cfg)
    _compare("many-target match", res, ref, truth)


def phase_aot_orb(case, flagship_res):
    import jax
    import fastest_image_pattern_matching_tpu as fipm
    from fastest_image_pattern_matching_tpu.utils import scenes
    from fastest_image_pattern_matching_tpu.utils.compile_cache import (
        CHECKOUT_DIR)
    pack_dir = os.path.join(CHECKOUT_DIR, ".aot_packs")
    os.makedirs(pack_dir, exist_ok=True)
    path = os.path.join(pack_dir, "chip_smoke_flagship.npz")
    # Executables only: jax.export's portable serialization needs the
    # optional flatbuffers package, which a GPU machine may lack.
    fipm.export_match_pack(path, case["pattern"], case["cfg"],
                           case["scene"].shape, include_executables=True,
                           portable=False)
    m = fipm.AotMatcher.load(path)
    res = m.match(case["scene"])
    same = flagship_res is not None and len(res) == len(flagship_res) and all(
        (a.score, a.angle, a.center) == (b.score, b.angle, b.center)
        for a, b in zip(res, flagship_res))
    check("AotMatcher (bundled executable) == phase 3 match",
          same and m._fns["single"]._from_exe,
          f"platforms={m.platforms} n={len(res)} "
          f"from_executable={m._fns['single']._from_exe}")
    os.remove(path)

    rng = np.random.default_rng(5)
    tpl = scenes.flagship_template(rng)[100:300, 150:450]
    src = rng.integers(0, 40, (600, 800), dtype=np.uint8)
    scenes.paste_rotated(src, tpl, 420.0, 310.0, 25.0)
    got = fipm.orb_match(src, tpl)
    ref = _on_cpu(fipm.orb_match, src, tpl)
    hd = (float(np.abs(np.asarray(got.homography)
                       - np.asarray(ref.homography)).max())
          if got.homography is not None and ref.homography is not None
          else float("inf"))
    check("orb_match vs CPU device",
          got.num_inliers == ref.num_inliers and hd <= 1e-2,
          f"inliers={got.num_inliers}/{ref.num_inliers} |dH|={hd:.3g}")
    del jax


def _compare_arrays(name, out, ref):
    """Sharded vs single-device result arrays: the same valid matches,
    bitwise (every per-candidate computation is the same arithmetic in
    the same order whatever the partition). The largest angle distance in
    float32 ulps is printed beside."""
    v = out["valid"]
    same = np.array_equal(v, ref["valid"]) and all(
        np.array_equal(out[k][v], ref[k][v])
        for k in ("score", "center", "angle"))
    a = out["angle"][v].astype(np.float32)
    b = ref["angle"][v].astype(np.float32)
    ulp = np.spacing(np.maximum(np.abs(a), np.abs(b)))
    ulps = float((np.abs(a.astype(np.float64) - b) / ulp).max(initial=0))
    check(f"{name} == single device", same,
          f"valid={int(v.sum())} bitwise={same} angle max {ulps:g} ulp")


def phase_four_cards(cases):
    """The sharded paths on a 4-GPU mesh vs the single-device results."""
    import jax
    import fastest_image_pattern_matching_tpu as fipm
    from fastest_image_pattern_matching_tpu.models import batch
    case = cases["flagship"]
    scene, pat, cfg = case["scene"], case["pattern"], case["cfg"]
    shifts = [(0, 0), (7, -5), (-11, 13), (3, 21)]
    frames = np.stack([np.roll(scene, s, axis=(0, 1)) for s in shifts])
    single = fipm.match_many_arrays(frames, pat, cfg)
    for shape in [(4, 1), (1, 4)]:
        mesh = fipm.make_mesh(shape)
        out = fipm.match_batch_sharded(frames, pat, cfg, mesh=mesh)
        _compare_arrays(f"match_batch_sharded mesh {shape}", out, single)

    m = cases["many"]
    glyphs = [m["pattern"], fipm.learn_pattern(
        np.ascontiguousarray(m["tpl"][::-1]), m["cfg"].min_reduce_area)]
    sharded = fipm.match_patterns_sharded(m["scene"], glyphs, m["cfg"],
                                          mesh=fipm.make_data_mesh())
    plain = batch.match_patterns(m["scene"], glyphs, m["cfg"])
    same = all(np.array_equal(a[k], b[k]) for a, b in zip(sharded, plain)
               for k in ("valid", "score", "center"))
    check("match_patterns_sharded (4 cards) == single device", same)

    rng = np.random.default_rng(5)
    tpl = rng.integers(0, 256, (120, 160), dtype=np.uint8)
    srcs = rng.integers(0, 40, (4, 480, 640), dtype=np.uint8)
    for i in range(4):
        srcs[i, 100 + 20 * i:220 + 20 * i, 200:360] = tpl
    sh = fipm.orb_match_many_sharded(srcs, tpl, mesh=fipm.make_data_mesh())
    pl = fipm.orb_match_many(srcs, tpl)
    check("orb_match_many_sharded (4 cards) == single device",
          [r.num_inliers for r in sh] == [r.num_inliers for r in pl])
    del jax


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded paths on a 4-GPU mesh")
    args = ap.parse_args(argv)

    import jax
    if jax.default_backend() != "gpu":
        print(f"chip_smoke: no GPU (backend {jax.default_backend()!r})",
              file=sys.stderr)
        return 2
    want = 4 if args.four_cards else 1
    if len(jax.devices()) < want:
        print(f"chip_smoke: needs {want} GPUs, found {len(jax.devices())}",
              file=sys.stderr)
        return 2
    from fastest_image_pattern_matching_tpu.utils.compile_cache import (
        enable_compile_cache)
    log(f"compile cache: {enable_compile_cache()}")

    run_phase("1 device", phase_device)
    cases = run_phase("setup scenes", _plans)
    if cases is None:
        return 1
    if args.four_cards:
        run_phase("four cards", phase_four_cards, cases)
    else:
        from fastest_image_pattern_matching_tpu.ops.pyramid import (
            build_pyramid)
        import jax.numpy as jnp
        fl = cases["flagship"]
        fl["pyr_top"] = np.asarray(build_pyramid(
            jnp.asarray(fl["scene"], jnp.float32), fl["plan"].top)[-1])
        run_phase("2 parity", phase_parity, cases)
        res = run_phase("3 flagship", phase_flagship, fl)
        run_phase("4 many targets", phase_many, cases["many"])
        run_phase("5 aot+orb", phase_aot_orb, fl, res)

    if FAILURES:
        log(f"FAILED: {FAILURES}")
        return 1
    d = jax.devices()
    log(nvidia_smi_line())  # the card's name and power limit, as printed
    print(json.dumps({"ok": True, "device": {
        "platform": d[0].platform, "kind": d[0].device_kind,
        "count": len(d)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
