"""The one place that picks an implementation per platform (paths.py)."""

import dataclasses

import pytest

from spacetime_tpu import paths
from spacetime_tpu.ops import raytrace


def test_auto_is_xla_on_the_test_platform():
    assert paths.for_platform() == paths.Paths(physics="xla", pixel="xla")
    assert paths.pixel_path("auto") == "xla"


@pytest.mark.parametrize(
    "platform,pixel", [("cpu", "xla"), ("gpu", "triton")]
)
def test_known_platforms(platform, pixel):
    p = paths.for_platform(platform)
    assert p.physics == "xla"
    assert p.pixel == pixel


@pytest.mark.parametrize("platform", ["rocm", "METAL", "xpu", ""])
def test_unknown_platform_raises(platform):
    with pytest.raises(RuntimeError, match="no implementation"):
        paths.for_platform(platform)


def test_gpu_choice_under_monkeypatched_platform(monkeypatch):
    monkeypatch.setattr(paths, "_platform", lambda: "gpu")
    assert paths.pixel_path("auto") == "triton"
    monkeypatch.setattr(paths, "_platform", lambda: "rocm")
    with pytest.raises(RuntimeError):
        paths.pixel_path("auto")


@pytest.mark.parametrize("backend", ["xla", "triton"])
def test_explicit_backend_wins(monkeypatch, backend):
    monkeypatch.setattr(paths, "_platform", lambda: "gpu")
    assert paths.pixel_path(backend) == backend


@pytest.mark.parametrize("backend", ["pallas", "pallas_interpret", "cuda"])
def test_unknown_backend_raises(backend):
    with pytest.raises(ValueError, match="unknown pixel backend"):
        paths.pixel_path(backend)


def test_render_params_have_no_kernel_switches():
    """The kernel-selection options of the removed kernels are gone; interpret mode is an explicit test
    argument that defaults off."""
    fields = {f.name for f in dataclasses.fields(raytrace.RenderParams)}
    assert "band_kernel" not in fields and "shard" not in fields
    assert raytrace.RenderParams().triton_interpret is False
    assert raytrace.RenderParams().backend == "auto"
