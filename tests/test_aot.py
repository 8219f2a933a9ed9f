"""AOT pack export/load: results identical to the traced path, no
retracing of the match program in the loading process (we can't assert
"no tracing" directly, but we assert the pack round-trips through disk
into a fresh cache-less call path and matches bit-for-bit)."""

import numpy as np
import pytest

import fastest_image_pattern_matching_tpu as fipm
from fastest_image_pattern_matching_tpu import aot


def _scene(seed=3, hw=(240, 320), tpl_hw=(48, 40), n=3):
    rng = np.random.default_rng(seed)
    tpl = rng.integers(0, 255, tpl_hw, dtype=np.uint8)
    scene = rng.integers(90, 140, hw, dtype=np.uint8)
    ys = [10, 120, 60]
    xs = [20, 200, 120]
    for i in range(n):
        scene[ys[i]:ys[i] + tpl_hw[0], xs[i]:xs[i] + tpl_hw[1]] = tpl
    return scene, tpl


@pytest.fixture(scope="module")
def pack(tmp_path_factory):
    scene, tpl = _scene()
    cfg = fipm.MatchConfig(max_pos=5, score=0.6, tolerance_angle=10.0)
    pat = fipm.learn_pattern(tpl, cfg.min_reduce_area)
    path = str(tmp_path_factory.mktemp("aot") / "pack.npz")
    timings = fipm.export_match_pack(path, pat, cfg, scene.shape,
                                     batch_sizes=(2,))
    assert "single" in timings
    return path, scene, tpl, cfg, pat


def test_roundtrip_matches_traced(pack):
    path, scene, tpl, cfg, pat = pack
    m = fipm.AotMatcher.load(path)
    ref = fipm.match(scene, pat, cfg)
    got = m.match(scene)
    assert len(got) == len(ref) == 3
    for a, b in zip(got, ref):
        assert a.score == b.score
        assert a.angle == b.angle
        assert a.center == b.center


def test_loaded_config_and_pattern(pack):
    path, scene, tpl, cfg, pat = pack
    m = fipm.AotMatcher.load(path)
    assert m.config == cfg
    assert m.src_shape == scene.shape
    assert len(m.pattern.levels) == len(pat.levels)
    np.testing.assert_array_equal(m.pattern.levels[0].templ,
                                  pat.levels[0].templ)


def test_batched_program(pack):
    path, scene, tpl, cfg, pat = pack
    m = fipm.AotMatcher.load(path)
    assert m.batch_sizes == [2]
    frames = np.stack([scene, np.roll(scene, 8, axis=0)])
    got = m.match_many(frames)
    ref = fipm.match_many(frames, pat, cfg, batch_bucket=2)
    assert [len(g) for g in got] == [len(r) for r in ref]
    for gs, rs in zip(got, ref):
        for a, b in zip(gs, rs):
            assert a.score == b.score
            assert a.center == b.center
    # B=1 pads into the bucket-2 program
    one = m.match_many(frames[:1])
    assert len(one) == 1 and len(one[0]) == len(ref[0])


def test_shape_and_bucket_guards(pack):
    path, scene, tpl, cfg, pat = pack
    m = fipm.AotMatcher.load(path)
    with pytest.raises(ValueError, match="shape"):
        m.match(scene[:-8])
    with pytest.raises(ValueError, match="batch"):
        m.match_many(np.stack([scene] * 3))


def test_overflow_falls_back(pack):
    """A scene with more above-threshold candidates than the NMS cap must
    still return the exact uncapped result (via the uncapped program in
    the pack, or the traced fallback)."""
    rng = np.random.default_rng(0)
    tpl = rng.integers(0, 255, (24, 24), dtype=np.uint8)
    hw = (600, 800)
    scene = rng.integers(90, 140, hw, dtype=np.uint8)
    n = 0
    for y in range(8, hw[0] - 30, 36):
        for x in range(8, hw[1] - 30, 36):
            scene[y:y + 24, x:x + 24] = tpl
            n += 1
    cfg = fipm.MatchConfig(max_pos=200, score=0.5, tolerance_angle=0.0,
                           max_overlap=0.5, min_reduce_area=64)
    pat = fipm.learn_pattern(tpl, cfg.min_reduce_area)
    import tempfile, os
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "p.npz")
        fipm.export_match_pack(path, pat, cfg, hw)
        m = fipm.AotMatcher.load(path)
        got = m.match(scene)
    ref = fipm.match(scene, pat, cfg)
    assert len(got) == len(ref) > 0
    for a, b in zip(got, ref):
        assert a.score == b.score
        assert a.center == b.center


def test_pack_dual_range_and_regions(tmp_path):
    """AOT pack round-trips the dual tolerance-range mode and a pattern
    learned with roi= and marked regions (the config/pattern surface a
    deployment actually freezes)."""
    rng = np.random.default_rng(9)
    full = rng.integers(0, 255, (70, 90), dtype=np.uint8)
    roi = (20, 10, 40, 48)
    tpl = full[roi[1]:roi[1] + roi[3], roi[0]:roi[0] + roi[2]]
    scene = rng.integers(90, 140, (220, 300), dtype=np.uint8)
    scene[60:60 + roi[3], 110:110 + roi[2]] = tpl
    cfg = fipm.MatchConfig(max_pos=3, score=0.6,
                           tolerance_ranges=(-8.0, 8.0, 172.0, 188.0))
    pat = fipm.learn_pattern(full, cfg.min_reduce_area, roi=roi,
                             regions=[[(2, 2), (30, 2), (16, 40)]])
    path = str(tmp_path / "pack.npz")
    fipm.export_match_pack(path, pat, cfg, scene.shape)
    m = fipm.AotMatcher.load(path)
    assert m.config.tolerance_ranges == (-8.0, 8.0, 172.0, 188.0)
    assert m.pattern.roi == roi
    assert len(m.pattern.regions) == 1
    ref = fipm.match(scene, pat, cfg)
    got = m.match(scene)
    assert len(got) == len(ref) >= 1
    for a, b in zip(got, ref):
        assert a.score == b.score and a.center == b.center
        # marked regions projected into the match frame, like match()
        assert len(a.regions) == 1
        np.testing.assert_allclose(a.regions[0], b.regions[0])


def test_pack_with_bundled_executables(tmp_path):
    """include_executables bundles this backend's compiled executables;
    a fresh SINGLE-DEVICE process must load them (no XLA pipeline) and
    match identically. Bundling is gated on one visible device (jax's
    serialize_executable mis-assigns under multi-device clients), so the
    suite's forced 8-device mesh exports without executables and this
    test runs the real path in a subprocess."""
    import subprocess
    import sys

    import numpy as np
    import cv2
    import fastest_image_pattern_matching_tpu as fipm

    rng = np.random.default_rng(5)
    t = np.full((40, 56), 30, np.uint8)
    cv2.rectangle(t, (4, 4), (51, 35), 200, 2)
    cv2.line(t, (8, 8), (48, 30), 255, 3)
    src = rng.integers(0, 30, (200, 240), np.uint8)
    src[40:80, 60:116] = t
    pat = fipm.learn_pattern(t, 256)
    cfg = fipm.MatchConfig(max_pos=3, score=0.8, tolerance_angle=180.0)

    # In THIS (8-device) process bundling is refused -> portable pack.
    p8 = str(tmp_path / "no_exe.npz")
    fipm.export_match_pack(p8, pat, cfg, src.shape,
                           include_executables=True)
    assert "exe_single" not in np.load(p8).files

    np.save(str(tmp_path / "src.npy"), src)
    np.save(str(tmp_path / "tpl.npy"), t)
    ref = fipm.match(src, pat, cfg)
    child = f"""
import os
os.environ.pop("XLA_FLAGS", None)
import jax; jax.config.update("jax_platforms", "cpu")
import numpy as np, sys
sys.path.insert(0, {repr(__import__('os').path.dirname(__import__('os').path.dirname(__import__('os').path.abspath(__file__))))})
import fastest_image_pattern_matching_tpu as fipm
from fastest_image_pattern_matching_tpu import aot as _aot
src = np.load({str(tmp_path / 'src.npy')!r})
tpl = np.load({str(tmp_path / 'tpl.npy')!r})
pat = fipm.learn_pattern(tpl, 256)
cfg = fipm.MatchConfig(max_pos=3, score=0.8, tolerance_angle=180.0)
path = {str(tmp_path / 'exe.npz')!r}
fipm.export_match_pack(path, pat, cfg, src.shape, batch_sizes=(2,),
                       include_executables=True)
data = np.load(path)
assert "exe_single" in data.files and "exe_batch_2" in data.files, data.files
calls = []
orig = _aot._load_exe
def spy(raw):
    calls.append(len(raw))
    return orig(raw)
_aot._load_exe = spy
m = fipm.AotMatcher.load(path)
assert len(calls) == 0, calls  # lazy: nothing deserialized at load
res = m.match(src)
many = m.match_many(np.stack([src, src]))
_aot._load_exe = orig
assert len(calls) >= 2, calls  # single + batch_2 loaded on first use
assert len(many) == 2 and len(many[0]) == 1
assert m._fns["single"]._from_exe and m._fns["batch_2"]._from_exe
# A pack of bundled executables only (no portable blobs) serves the
# match from its executable.
path2 = {str(tmp_path / 'exe_only.npz')!r}
fipm.export_match_pack(path2, pat, cfg, src.shape, include_executables=True,
                       portable=False)
data2 = np.load(path2)
assert not [k for k in data2.files if k.startswith("exp_")], data2.files
m2 = fipm.AotMatcher.load(path2)
res2 = m2.match(src)
assert m2._fns["single"]._from_exe
assert [(r.score, r.center) for r in res2] == [(r.score, r.center) for r in res]
print("CHILD_OK", len(res), round(res[0].score, 6))
"""
    env = dict(__import__("os").environ)
    env.pop("XLA_FLAGS", None)
    out = subprocess.run([sys.executable, "-c", child], env=env,
                         capture_output=True, text=True, timeout=480)
    last = out.stdout.strip().splitlines()[-1] if out.stdout.strip() else ""
    assert last.startswith("CHILD_OK"), out.stdout + out.stderr[-2000:]
    n, score = last.split()[1:3]
    assert int(n) == len(ref) == 1
    assert abs(float(score) - ref[0].score) < 1e-6


def test_platform_names_follow_jax_export():
    """Packs name platforms as jax.export does ("cuda", not the "gpu" of
    jax.default_backend()); a pack exported on a GPU loads on a GPU."""
    assert aot._current_platform() == "cpu"
    aot._check_platform(["cuda"], current="cuda")
    aot._check_platform(["cpu", "cuda"], current="cuda")
    with pytest.raises(ValueError, match="re-export"):
        aot._check_platform(["cuda"], current="cpu")
    with pytest.raises(ValueError, match="re-export"):
        aot._check_platform(["gpu"], current="cuda")


def test_pack_for_another_platform_is_refused(pack, tmp_path):
    path = pack[0]
    data = dict(np.load(path))
    data["platforms"] = np.frombuffer(b'["cuda"]', np.uint8)
    other = str(tmp_path / "cuda_pack.npz")
    np.savez(other, **data)
    with pytest.raises(ValueError, match="exported for \\['cuda'\\]"):
        fipm.AotMatcher.load(other)


def test_export_fails_loudly_without_serializer(tmp_path, monkeypatch):
    """Where jax.export cannot serialize (no flatbuffers package) export
    raises, naming the executables-only alternative, and writes nothing."""
    from jax import export as jexport
    scene, tpl = _scene()
    cfg = fipm.MatchConfig(max_pos=5, score=0.6, tolerance_angle=10.0)
    pat = fipm.learn_pattern(tpl, cfg.min_reduce_area)

    def no_flatbuffers(self, *a, **k):
        raise ImportError("Please install 'flatbuffers'")
    monkeypatch.setattr(jexport.Exported, "serialize", no_flatbuffers)
    path = tmp_path / "none.npz"
    with pytest.raises(ImportError, match="portable=False"):
        fipm.export_match_pack(str(path), pat, cfg, scene.shape)
    assert not path.exists()


def test_executables_only_pack_options_are_checked(tmp_path):
    """portable=False needs bundled executables, and those need exactly
    one device (this suite runs on a forced multi-device CPU)."""
    import jax
    scene, tpl = _scene()
    cfg = fipm.MatchConfig(max_pos=5, score=0.6, tolerance_angle=10.0)
    pat = fipm.learn_pattern(tpl, cfg.min_reduce_area)
    path = str(tmp_path / "p.npz")
    with pytest.raises(ValueError, match="include_executables"):
        fipm.export_match_pack(path, pat, cfg, scene.shape, portable=False)
    assert len(jax.devices()) > 1
    with pytest.raises(ValueError, match="one visible device"):
        fipm.export_match_pack(path, pat, cfg, scene.shape,
                               include_executables=True, portable=False)


def test_pack_without_runnable_program_is_refused(pack, tmp_path):
    """A pack whose program has neither a portable blob nor an executable
    usable here is refused at load, never re-traced."""
    data = dict(np.load(pack[0]))
    del data["exp_single"]
    other = str(tmp_path / "no_single.npz")
    np.savez(other, **data)
    with pytest.raises(ValueError, match="'single' has no portable blob"):
        fipm.AotMatcher.load(other)
