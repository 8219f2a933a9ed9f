"""Accelerator MatchConfig knobs: two_phase and narrow_candidates.

Both are alternate dispatch pipelines (template_matcher._dispatch /
descend_range) that previously had no CPU coverage. two_phase is
result-exact by construction (only already-dead candidates are dropped
between phases); narrow_candidates is a documented divergence knob that
keeps the top scorers — exact whenever every surviving target ranks
within the narrowed bound, which these scenes guarantee.
"""

import dataclasses

import cv2
import numpy as np
import pytest

import fastest_image_pattern_matching_tpu as fipm


def _build_scene(rng, tpl, placements, shape=(420, 460)):
    """Paste rotated template instances into a noise background (the same
    construction as bench.py's flagship scene)."""
    H, W = shape
    scene = rng.integers(0, 40, size=(H, W), dtype=np.uint8)
    th, tw = tpl.shape
    diag = int(np.ceil(np.hypot(th, tw))) + 4
    for (cx, cy, ang) in placements:
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
    return scene


@pytest.fixture(scope="module")
def scene_and_pattern():
    rng = np.random.default_rng(3)
    # 96x96 template: layer 0 (9216 px) exceeds the 4096-px gate that both
    # knobs trigger on, with a 3-level pyramid above it.
    tpl = np.full((96, 96), 60, np.uint8)
    cv2.rectangle(tpl, (8, 8), (87, 87), 200, 6)
    cv2.circle(tpl, (48, 48), 22, 240, -1)
    cv2.line(tpl, (12, 80), (80, 16), 20, 5)
    tpl = cv2.add(tpl, rng.integers(0, 15, tpl.shape, dtype=np.uint8))
    scene = _build_scene(rng, tpl, [(110.0, 120.0, 10.0),
                                    (300.0, 140.0, -25.0),
                                    (180.0, 320.0, 0.0)])
    pattern = fipm.learn_pattern(tpl, 256)
    return scene, pattern


def _cfg(**kw):
    base = dict(max_pos=5, score=0.7, tolerance_angle=30.0, max_overlap=0.2)
    base.update(kw)
    return fipm.MatchConfig(**base)


def test_two_phase_split_exists(scene_and_pattern):
    """The scene is constructed so the adaptive split actually engages —
    otherwise two_phase silently tests nothing."""
    from fastest_image_pattern_matching_tpu.models.template_matcher import (
        _make_plan, _stage_split, _stats_key)
    scene, pattern = scene_and_pattern
    cfg = _cfg(two_phase=True)
    plan = _make_plan(scene.shape, pattern, cfg)
    stats = tuple((lv.mean, lv.norm, lv.inv_area, lv.result_equal1)
                  for lv in pattern.levels)
    assert _stage_split(plan, _stats_key(stats)) is not None


def test_two_phase_equals_default(scene_and_pattern):
    scene, pattern = scene_and_pattern
    base = fipm.match_arrays(scene, pattern, _cfg())
    two = fipm.match_arrays(scene, pattern, _cfg(two_phase=True))
    assert np.array_equal(base["valid"], two["valid"])
    np.testing.assert_allclose(two["score"], base["score"], atol=1e-6)
    np.testing.assert_allclose(two["center"][base["valid"]],
                               base["center"][base["valid"]], atol=1e-4)
    np.testing.assert_allclose(two["angle"][base["valid"]],
                               base["angle"][base["valid"]], atol=1e-4)
    assert int(base["valid"].sum()) == 3  # all three planted targets


def test_two_phase_empty_scene(scene_and_pattern):
    """No candidates above threshold: phase A short-circuits host-side."""
    _, pattern = scene_and_pattern
    rng = np.random.default_rng(8)
    noise = rng.integers(0, 40, size=(420, 460), dtype=np.uint8)
    out = fipm.match_arrays(noise, pattern, _cfg(two_phase=True))
    assert not out["valid"].any()


def test_narrow_candidates_strong_targets_exact(scene_and_pattern):
    """With targets that rank at the top of the sweep, narrowing to the
    top scorers must not change anything (the documented-safe regime)."""
    scene, pattern = scene_and_pattern
    base = fipm.match_arrays(scene, pattern, _cfg())
    nar = fipm.match_arrays(scene, pattern, _cfg(narrow_candidates=True))
    assert np.array_equal(base["valid"], nar["valid"])
    np.testing.assert_allclose(nar["score"], base["score"], atol=1e-6)
    np.testing.assert_allclose(nar["center"][base["valid"]],
                               base["center"][base["valid"]], atol=1e-4)


def test_narrow_candidates_bound(scene_and_pattern):
    """The narrowed candidate set is max(2*max_pos+4, 16) — with max_pos=1
    that is 16; all three targets must still surface as the top scorer is
    re-selected per dispatch."""
    scene, pattern = scene_and_pattern
    out = fipm.match_arrays(scene, pattern,
                            _cfg(max_pos=1, narrow_candidates=True))
    assert int(out["valid"].sum()) == 1
    assert out["score"][0] > 0.9


def test_compute_dtype_variants_agree():
    """bf16 (default) and f32 correlation paths must find identical
    targets with scores within float tolerance (both are exact schemes on
    u8-valued inputs; ncc-level parity is in test_ncc, this pins the
    MatchConfig plumbing end-to-end). No other compute dtype is accepted."""
    import fastest_image_pattern_matching_tpu as fipm
    rng = np.random.default_rng(17)
    tpl = rng.integers(0, 255, (36, 44), dtype=np.uint8)
    scene = rng.integers(80, 150, (200, 260), dtype=np.uint8)
    scene[40:76, 60:104] = tpl
    scene[120:156, 170:214] = tpl
    pat = fipm.learn_pattern(tpl, 256)
    res = {}
    for dt in ("bf16", "f32"):
        cfg = fipm.MatchConfig(max_pos=4, score=0.6, tolerance_angle=12.0,
                               compute_dtype=dt)
        res[dt] = fipm.match(scene, pat, cfg)
    assert len(res["bf16"]) == len(res["f32"]) == 2
    for a, b in zip(res["bf16"], res["f32"]):
        assert abs(a.score - b.score) < 5e-3
        assert abs(a.pos_x - b.pos_x) < 0.75 and abs(a.pos_y - b.pos_y) < 0.75
    with pytest.raises(ValueError, match="compute_dtype"):
        fipm.MatchConfig(compute_dtype="int8")


def test_quantize_warp_off():
    """quantize_warp=False (fractional canvases, bf16 forced) must still
    recover the planted rotated target within tolerance of the default."""
    import cv2
    import fastest_image_pattern_matching_tpu as fipm
    rng = np.random.default_rng(23)
    tpl = rng.integers(0, 255, (40, 52), dtype=np.uint8)
    scene = rng.integers(70, 140, (240, 320), dtype=np.uint8)
    diag = 80
    canvas = np.zeros((diag, diag), np.uint8)
    canvas[20:60, 14:66] = tpl
    m = cv2.getRotationMatrix2D((39.5, 39.5), 25.0, 1)
    rc = cv2.warpAffine(canvas, m, (diag, diag))
    mask = cv2.warpAffine((canvas > 0).astype(np.uint8) * 255, m,
                          (diag, diag), flags=cv2.INTER_NEAREST)
    reg = scene[80:160, 120:200]
    reg[mask > 0] = rc[mask > 0]
    pat = fipm.learn_pattern(tpl, 256)
    base_cfg = fipm.MatchConfig(max_pos=1, score=0.5, tolerance_angle=40.0)
    a = fipm.match(scene, pat, base_cfg)
    b = fipm.match(scene, pat, dataclasses.replace(base_cfg,
                                                   quantize_warp=False))
    assert len(a) == len(b) == 1
    assert abs(a[0].angle - b[0].angle) < 0.5
    assert abs(a[0].pos_x - b[0].pos_x) < 1.0
    assert abs(a[0].score - b[0].score) < 0.02


def test_max_candidates_cap():
    """max_candidates trims the refinement set to the top scorers; with a
    cap comfortably above the true target count, results are unchanged;
    the pathological cap=1 still returns the single best target."""
    import fastest_image_pattern_matching_tpu as fipm
    rng = np.random.default_rng(31)
    tpl = rng.integers(0, 255, (32, 32), dtype=np.uint8)
    scene = rng.integers(90, 150, (220, 280), dtype=np.uint8)
    for y, x in ((20, 30), (100, 120), (160, 220)):
        scene[y:y + 32, x:x + 32] = tpl
    pat = fipm.learn_pattern(tpl, 256)
    full = fipm.match(scene, pat, fipm.MatchConfig(
        max_pos=5, score=0.6, tolerance_angle=10.0))
    capped = fipm.match(scene, pat, fipm.MatchConfig(
        max_pos=5, score=0.6, tolerance_angle=10.0, max_candidates=64))
    assert len(full) == len(capped) == 3
    for a, b in zip(full, capped):
        assert a.score == b.score and a.center == b.center
    one = fipm.match(scene, pat, fipm.MatchConfig(
        max_pos=5, score=0.6, tolerance_angle=10.0, max_candidates=1))
    assert len(one) == 1 and one[0].score == full[0].score
