"""The measurement layer: compile-cache placement, the roofline table, the
profiler-trace reduction, and chip_smoke.py's refusal to run off the card."""

import gzip
import json
import os
import subprocess
import sys

import pytest

from spacetime_tpu.utils import cache, profiling, roofline

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cache_dir_in_child(env_value):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    if env_value is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = env_value
    code = ("import jax; from spacetime_tpu.utils.cache import "
            "enable_compilation_cache as e; print(e()); "
            "print(jax.config.jax_compilation_cache_dir)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, check=True)
    return out.stdout.split()


def test_cache_honours_the_environment_variable(tmp_path):
    want = str(tmp_path / "elsewhere")
    assert _cache_dir_in_child(want) == [want, want]


def test_cache_default_is_fixed_in_the_checkout():
    got = _cache_dir_in_child(None)
    assert got == [cache.DEFAULT_DIR, cache.DEFAULT_DIR]
    assert cache.DEFAULT_DIR == os.path.join(ROOT, ".jax_cache")


def test_roofline_has_the_h100_row():
    pk = roofline.peak_for("NVIDIA H100 80GB HBM3")
    assert pk.flops_f32 == 67e12 and pk.hbm_Bps == 3.35e12
    assert "datasheet" in pk.source
    r = roofline.Roofline(flops=67e9, bytes_accessed=3.35e9, seconds=2e-3,
                          chip="NVIDIA H100 80GB HBM3")
    assert r.flops_util == pytest.approx(0.5)
    assert r.hbm_util == pytest.approx(0.5)


@pytest.mark.parametrize("kind", ["cpu", "NVIDIA A100-SXM4-80GB", ""])
def test_roofline_unknown_device_raises(kind):
    with pytest.raises(KeyError, match="no published peaks"):
        roofline.peak_for(kind)
    with pytest.raises(KeyError):
        roofline.Roofline(1.0, 1.0, 1.0, kind).flops_util


def _write_trace(tmp_path, events):
    d = tmp_path / "plugins" / "profile" / "run"
    d.mkdir(parents=True)
    with gzip.open(d / "host.trace.json.gz", "wt") as f:
        json.dump({"traceEvents": events}, f)
    return str(tmp_path)


def _gpu_trace_events():
    meta = [
        {"ph": "M", "name": "process_name", "pid": 1,
         "args": {"name": "/device:GPU:0"}},
        {"ph": "M", "name": "process_name", "pid": 7,
         "args": {"name": "/host:CPU"}},
    ]
    kernels = [
        # launched alone: the op path rides in args.name
        {"ph": "X", "pid": 1, "tid": 13, "ts": 0.0, "dur": 10.0,
         "name": "sort", "args": {"name": "jit(frame)/jit(step)/sort"}},
        # replayed in a CUDA graph: only the fusion name
        {"ph": "X", "pid": 1, "tid": 13, "ts": 10.0, "dur": 30.0,
         "name": "loop_and_fusion", "args": {"hlo_op": "command_buffer"}},
        {"ph": "X", "pid": 1, "tid": 13, "ts": 100.0, "dur": 20.0,
         "name": "pixel_pass", "args": {"hlo_op": "command_buffer"}},
        # overlaps the previous kernel on a second stream
        {"ph": "X", "pid": 1, "tid": 14, "ts": 110.0, "dur": 20.0,
         "name": "input_reduce_fusion", "args": {}},
    ]
    host = [{"ph": "X", "pid": 7, "tid": 1, "ts": 0.0, "dur": 500.0,
             "name": "python", "args": {}}]
    return meta + kernels + host


HLO = """
  %loop_and_fusion = f32[8]{0} fusion(f32[8]{0} %p), kind=kLoop, metadata={op_name="jit(frame)/jit(render_retarded_with_diag)/mul" source_file="x.py"}
  ROOT %pixel_pass = f32[8]{0} custom-call(f32[8]{0} %q), metadata={op_name="jit(frame)/jit(render_retarded_with_diag)/pixel_pass"}
"""


def test_trace_reduction_on_a_gpu_trace(tmp_path):
    d = _write_trace(tmp_path, _gpu_trace_events())
    tot = profiling.measured_totals(d, 2)
    # busy = [0, 40) + [100, 130) = 70 us over a 130 us window, per 2 iters
    assert tot["device_s"] == pytest.approx(35e-6)
    assert tot["kernel_s"] == pytest.approx(40e-6)
    assert tot["idle_share"] == pytest.approx(1 - 70 / 130)
    st = profiling.parse_stage_durations(d, 1, HLO)
    assert st["step"] == pytest.approx(10e-6)
    assert st["render"] == pytest.approx(50e-6)
    assert st["other"] == pytest.approx(20e-6)
    assert st["total"] == pytest.approx(80e-6)


def test_trace_reduction_raises_on_no_device_kernels(tmp_path):
    events = [e for e in _gpu_trace_events() if e.get("pid") != 1]
    d = _write_trace(tmp_path, events)
    with pytest.raises(RuntimeError, match="no device kernels"):
        profiling.measured_totals(d, 1)
    with pytest.raises(RuntimeError, match="no device kernels"):
        profiling.parse_stage_durations(d, 1)
    with pytest.raises(RuntimeError, match="no profiler trace"):
        profiling.measured_totals(str(tmp_path / "empty"), 1)


def test_trace_reduction_raises_when_it_attributes_nothing(tmp_path):
    events = [e for e in _gpu_trace_events()
              if e.get("name") not in ("sort", "pixel_pass")]
    d = _write_trace(tmp_path, events)
    assert profiling.measured_totals(d, 1)["device_s"] > 0
    with pytest.raises(RuntimeError, match="attributed"):
        profiling.parse_stage_durations(d, 1)  # no HLO names the fusions


def test_chip_smoke_device_check_refuses_the_cpu():
    from spacetime_tpu.utils import device

    with pytest.raises(SystemExit) as exc:
        device.require_gpu()
    assert exc.value.code != 0 and "no GPU" in str(exc.value.code)


def test_chip_smoke_exits_nonzero_without_a_card():
    env = dict(os.environ, JAX_PLATFORMS="cpu", PATH="/nonexistent")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
