"""Seeded numpy scenes (utils/scenes.py): shapes of the two deployments,
the paste geometry, and that the matcher finds what was planted."""

import numpy as np
import pytest

import fastest_image_pattern_matching_tpu as fipm
from fastest_image_pattern_matching_tpu.utils import scenes


def test_flagship_scene_shapes():
    scene, tpl, truth = scenes.flagship_scene(0)
    assert scene.shape == (3036, 4024) and scene.dtype == np.uint8
    assert tpl.shape == (521, 762) and tpl.dtype == np.uint8
    assert [round(a) for _, _, a in truth] == [0, -120, 120]


def test_many_targets_scene_shapes_and_spacing():
    scene, tpl, truth = scenes.many_targets_scene(0)
    assert scene.shape == (3648, 3648) and tpl.shape == (54, 54)
    assert len(truth) == 100
    c = np.array([(x, y) for x, y, _ in truth])
    d = np.abs(c[:, None] - c[None])
    apart = (d[..., 0] >= 54) | (d[..., 1] >= 54)
    assert apart[~np.eye(100, dtype=bool)].all()


def test_paste_unrotated_is_a_copy():
    tpl = np.random.default_rng(0).integers(0, 256, (10, 14), np.uint8)
    scene = np.zeros((40, 50), np.uint8)
    scenes.paste_rotated(scene, tpl, 20 + 7.0, 10 + 5.0, 0.0)
    np.testing.assert_array_equal(scene[10:20, 20:34], tpl)


@pytest.mark.parametrize("angle", [0.0, 33.0, -120.0])
def test_match_finds_pasted_target(angle):
    rng = np.random.default_rng(1)
    tpl = scenes.flagship_template(rng)[::4, ::4]
    scene = rng.integers(0, 40, (400, 480), dtype=np.uint8)
    truth = [(250.3, 190.7, angle)]
    scenes.paste_rotated(scene, tpl, *truth[0])
    cfg = fipm.MatchConfig(max_pos=1, score=0.6, tolerance_angle=180.0)
    res = fipm.match(scene, fipm.learn_pattern(tpl, 256), cfg)
    (px, deg), = scenes.match_truth_errors(res, truth)
    assert px <= 2.0 and deg <= 0.5, (px, deg)
