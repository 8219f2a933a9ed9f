"""Streaming soak benchmark: VideoCaptureSource -> inspect_corpus ->
batched matcher, ~120 frames — the reference's real deployment mode (the
camera live loop, src/CameraPreviewDialog.cpp:84-131, feeding Execute).

Two phases:
  1. File mode (latest_only=False): every frame of a 120-frame MJPG video
     (real Dst9 template planted at a known pose per frame) is decoded by
     the threaded cv2 grabber and pushed through the batched matcher
     (batch_size=8, one compiled dispatch per batch). Asserts the target
     is found on every frame; reports fps / ms-per-frame.
  2. Live mode (latest_only=True): the grabber's 1-deep latest-frame
     mailbox against a deliberately slow consumer — verifies the drop
     semantics (slow matches drop frames instead of back-pressuring the
     camera) and reports served vs dropped counts.

Output: one JSON object.
Usage: python tools/stream_bench.py --images "<reference>/Test Images"
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

N_FRAMES = 120
HW = (480, 640)


def _write_video(path, tpl, n=N_FRAMES, seed=5):
    """MJPG avi: dark noise background + one planted (axis-aligned) real
    template instance per frame at a deterministic walk of positions."""
    import cv2
    rng = np.random.default_rng(seed)
    th, tw = tpl.shape
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 30.0,
                         (HW[1], HW[0]), isColor=False)
    if not vw.isOpened():
        raise RuntimeError("VideoWriter failed to open (MJPG)")
    poses = []
    for i in range(n):
        f = rng.integers(0, 40, size=HW, dtype=np.uint8)
        y = int(40 + (i * 7) % (HW[0] - th - 80))
        x = int(40 + (i * 13) % (HW[1] - tw - 80))
        f[y:y + th, x:x + tw] = tpl
        poses.append((x + (tw - 1) / 2.0, y + (th - 1) / 2.0))
        vw.write(f)
    vw.release()
    return poses


def main():
    import argparse
    import tempfile
    ap = argparse.ArgumentParser(description="streaming soak benchmark")
    ap.add_argument("--images", required=True,
                    help="the reference's 'Test Images' directory")
    images = ap.parse_args().images
    import cv2
    import fastest_image_pattern_matching_tpu as fipm
    from fastest_image_pattern_matching_tpu.models.corpus import inspect_corpus
    from fastest_image_pattern_matching_tpu.utils.sources import (
        VideoCaptureSource)

    tpl = cv2.imread(os.path.join(images, "Dst9.bmp"), cv2.IMREAD_GRAYSCALE)
    path = os.path.join(tempfile.mkdtemp(), "fipm_stream_soak.avi")
    poses = _write_video(path, tpl)

    # MJPG is lossy: score threshold relaxed to 0.6, position must still
    # land within 2 px of the planted pose.
    cfg = fipm.MatchConfig(max_pos=1, score=0.6, tolerance_angle=0.0)
    pattern = fipm.learn_pattern(tpl, 256)

    # Warm up the batched program before the timed stream.
    warm = np.zeros((8,) + HW, np.uint8)
    fipm.match_many(warm, pattern, cfg, batch_bucket=8)

    src = VideoCaptureSource(path, latest_only=False)
    found_ok = 0
    pos_ok = 0
    n_seen = 0
    t0 = time.perf_counter()
    for rep in inspect_corpus(src, pattern, cfg, batch_size=8):
        n_seen += 1
        if rep.results:
            found_ok += 1
            r = rep.results[0]
            px, py = poses[rep.index]
            if abs(r.pos_x - px) < 2.0 and abs(r.pos_y - py) < 2.0:
                pos_ok += 1
    wall = time.perf_counter() - t0
    fps = n_seen / wall if wall > 0 else 0.0

    # Live mode: slow consumer against the latest-frame mailbox.
    served = 0
    with VideoCaptureSource(path, latest_only=True, timeout_s=2.0) as cam:
        for frame in cam.frames():
            served += 1
            time.sleep(0.05)  # consumer slower than the 30 fps stream
    dropped = N_FRAMES - served

    out = {
        "metric": "stream_soak",
        "frames": n_seen,
        "found_frames": found_ok,
        "position_ok_frames": pos_ok,
        "wall_s": round(wall, 2),
        "fps": round(fps, 1),
        "ms_per_frame": round(1000.0 * wall / max(n_seen, 1), 1),
        "live_mode_served": served,
        "live_mode_dropped": dropped,
        "ok": bool(n_seen == N_FRAMES and found_ok == N_FRAMES
                   and pos_ok >= N_FRAMES - 2 and dropped > 0),
    }
    print(json.dumps(out))
    os.unlink(path)
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
