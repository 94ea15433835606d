"""Test environment: the CPU with 8 virtual devices by default, so the whole
suite — multi-device sharding tests included — runs without an accelerator.
JAX_PLATFORMS is only defaulted: `JAX_PLATFORMS=cuda python -m pytest tests
-m gpu` runs the card-only tests (marker `gpu`, fixture `gpu` below) on a
GPU."""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import numpy as np  # noqa: E402
import pytest  # noqa: E402

import jax  # noqa: E402

from spacetime_tpu.utils.cache import enable_compilation_cache  # noqa: E402

# Persistent compilation cache: the suite is compile-dominated on CPU.
enable_compilation_cache()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)


@pytest.fixture
def gpu():
    """The GPU device for tests marked `gpu`; skips anywhere else.  Decided
    here, when the test runs — never at import or collection time, so every
    test worker collects the same tests."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs a GPU: JAX_PLATFORMS=cuda python -m pytest "
                    "tests -m gpu")
    return dev


@pytest.fixture
def rng():
    return np.random.default_rng(0)


# ---------------------------------------------------------------------------
# Fast/slow triage.  The full suite is oracle-heavy (f64 geodesic quadrature,
# multi-process DCN spawns, engine end-to-end renders) and takes ~27 min on
# the 8-virtual-device CPU mesh; CI and judging windows need a fast subset.
# Every test measured >= ~8 s wall (the distribution's knee) is marked
# `slow` here, in one place, keyed by (file, test-name) so parametrized
# variants inherit the mark.  Run `pytest -m "not slow"` for the ~5 min fast
# suite; the full suite stays the default (`pytest tests/`).
_SLOW = {
    ("test_boost.py", "test_camera_frame_matches_oracle"),
    ("test_btz.py", "test_btz_engine_config_renders"),
    ("test_btz.py", "test_btz_opaque_matches_geodesic_oracle"),
    ("test_btz.py", "test_btz_reflected_image_render"),
    ("test_btz.py", "test_spin_matches_exact_geodesic_oracle"),
    ("test_btz.py", "test_winding_image_render"),
    ("test_btz_exact.py", "test_exact_matches_shooting_oracle"),
    ("test_btz_exact.py", "test_exact_reduces_to_static_at_zero_spin"),
    ("test_btz_exact.py", "test_exact_spin_render"),
    ("test_btz_exact.py", "test_no_fallbacks_on_scene_grid"),
    ("test_curved.py", "test_conical_opaque_matches_oracle"),
    ("test_curved.py", "test_conical_opaque_zero_deficit_matches_flat_opaque"),
    ("test_curved.py", "test_double_image_around_defect"),
    ("test_curved.py", "test_engine_defect_motion_quasi_static"),
    ("test_curved.py", "test_multi_defect_opaque_matches_oracle"),
    ("test_curved.py", "test_single_defect_tuple_identical"),
    ("test_engine.py", "test_diag_adaptation_raises_bin_capacity"),
    ("test_engine.py", "test_fused_stage_attribution_profiler"),
    ("test_gravity.py", "test_engine_selfgravity_fused_frames"),
    ("test_materials.py", "test_creep_permanent_deformation_vs_elastic"),
    ("test_materials.py", "test_engine_materials_config_end_to_end"),
    ("test_multihost.py", "test_two_process_frame_matches_single_device"),
    ("test_multiview.py", "test_engine_render_views"),
    ("test_multiview.py", "test_render_views_boundary_and_planar"),
    ("test_multiview.py", "test_render_views_matches_single_camera_renders"),
    ("test_parallel.py", "test_engine_mesh_camera_frame"),
    ("test_parallel.py", "test_engine_mesh_checkpoint_roundtrip"),
    ("test_parallel.py", "test_engine_mesh_mode_parity"),
    ("test_parallel.py", "test_engine_mesh_production_kernels"),
    ("test_parallel.py", "test_engine_mesh_render_views"),
    ("test_parallel.py", "test_engine_mesh_retarded_sourced_defect"),
    ("test_parallel.py", "test_graft_dryrun_multichip"),
    ("test_parallel.py", "test_sharded_frame_matches_single_device"),
    ("test_parallel.py", "test_sharded_frame_no_full_ring_allgather"),
    ("test_replay.py", "test_bench_replay_harness_roundtrip"),
    ("test_replay.py", "test_record_then_replay_bit_exact"),
    ("test_rindler.py", "test_rindler_config_renders"),
    ("test_sanitizers.py", "test_checkify_catches_injected_nan"),
    ("test_sanitizers.py", "test_checkify_clean_through_collision"),
    ("test_worldline3d.py", "test_viewer_spin_keys"),
}


def pytest_collection_modifyitems(config, items):
    for item in items:
        name = getattr(item, "originalname", None) or item.name
        if (item.path.name, name) in _SLOW:
            item.add_marker(pytest.mark.slow)
