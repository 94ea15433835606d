"""Engine + scene configuration.

The reference has no runtime config at all — compile-time constants plus one
live-tweakable max-FPS field in the debug UI (reference:
src/twoplusone/mod.rs:12-38, src/debugui.rs:9-23).  SURVEY.md §5 calls a
small config system a strict improvement, needed to express the five
BASELINE.json benchmark configs; they are all constructible here by name.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from ..constants import DEFAULT_PARAMS, PhysicsParams
from ..ops.raytrace import RenderParams
from ..ops.worldline3d import Worldline3DParams


@dataclasses.dataclass(frozen=True)
class SceneSpec:
    """Scene description: bodies = (kind, arg, offset, vel, rgb) with kind in
    {"disc" (arg = particle count), "box" (arg = (w_px, h_px)),
     "image" (arg = PNG path — the reference's import path,
     src/twoplusone/softbody/mod.rs:117-189)}."""

    bodies: Tuple[tuple, ...]
    capacity: Optional[int] = None
    # pad bodies to their bounding boxes (regular bond offsets -> shifted-
    # slice spring physics, ~1.5x faster steps for ~1.3x capacity)
    lattice_pad: bool = True
    # per-body material id into EngineConfig.materials (None = all 0)
    material_indices: Optional[Tuple[int, ...]] = None


@dataclasses.dataclass(frozen=True, kw_only=True)
class EngineConfig:
    # kw_only: `name` precedes `scene`, so positional construction would
    # silently bind the SceneSpec to `name` — force keywords instead
    # registry key when built via get_config (replay sessions store it so
    # `bench.py --replay` can reconstruct the engine); "" for ad-hoc configs
    name: str = ""
    scene: SceneSpec = None
    physics: PhysicsParams = DEFAULT_PARAMS
    render: RenderParams = RenderParams()
    width: int = 256
    height: int = 256
    history: int = 512  # worldline ring capacity (ticks)
    cam_pos: Tuple[float, float] = (0.5, 0.5)
    cam_zoom: float = 1.0
    cam_vel: Tuple[float, float] = (0.0, 0.0)
    cam_accel: Tuple[float, float] = (0.0, 0.0)  # Rindler-style proper accel (config 4)
    max_fps: float = 72.0  # frame pacing target (reference: debugui.rs:21)
    render_mode: str = "retarded"  # retarded | points | instant | conical
    steps_per_frame: int = 1
    # conical-defect mass(es) for curved-spacetime mode: a single
    # ((cx, cy), deficit_rad) or a tuple of them (multi-defect scenes use
    # single-scattering superposition, ops/curved.py)
    defect: Optional[Tuple] = None
    # quasi-static defect motion: one (vx, vy) per defect
    defect_vel: Optional[Tuple[Tuple[float, float], ...]] = None
    # place moving defects at their RETARDED position on the camera's past
    # light cone (geometry changes propagate at c; engine._defects) instead
    # of quasi-statically at t_now.  Also applies to matter-sourced defects
    # (the retarded centroid is read from the worldline ring, ops/gravity)
    defect_retarded: bool = False
    # MATTER-SOURCED defects (self-consistent quasi-static gravity,
    # ops/gravity.py): tuple of (object_index, deficit) — the defect sits at
    # that object's relativistic-energy centroid, recomputed in-graph every
    # frame.  deficit None derives 8*pi*defect_G*energy.  Appended after the
    # static config.defect entries (either may be None).
    defect_source: Optional[Tuple] = None
    defect_G: float = 0.0  # 2+1D gravitational coupling for derived deficits
    # BTZ black hole for render_mode='btz': ((cx, cy), mass, ads_l) or
    # ((cx, cy), mass, ads_l, spin) — spin J adds slow-rotation frame
    # dragging (ops/btz.py BTZBlackHole; valid for |J| << M l)
    btz: Optional[Tuple] = None
    # view parameters for render_mode='worldline3d' (the reference's stub
    # worldline3d.glsl axis: the (x, y, t) block seen side-on)
    wl3d: Worldline3DParams = Worldline3DParams()
    # split-jit debug mode: run step / worldline push / render as separate
    # dispatches with device syncs so StatsWindow reports true per-stage ms
    # (the analog of the reference's GPU timestamp stages, querybank.rs:14-47)
    stage_timing: bool = False
    # read StepAux/RenderDiag every N frames: warn + adapt band/bin capacity
    diag_every: int = 30
    # per-material (k_scale, damping, break_scale) rows indexed by the
    # objects' material_index (ops/materials.py); None = one default material.
    # Rows are (k_scale, damping, break_scale[, creep_rate, yield_strain])
    materials: Optional[Tuple[Tuple[float, ...], ...]] = None


def _blob(count, offset, vel, rgb):
    return ("disc", count, tuple(offset), tuple(vel), tuple(rgb))


BLUE = (0.25, 0.35, 1.0)
RED = (1.0, 0.3, 0.25)


def config_single_blob() -> EngineConfig:
    """BASELINE config 1: single softbody blob, flat 2+1 Minkowski, static
    camera, 256x256 render (testimg3-scale: 3 965 particles)."""
    return EngineConfig(
        # blob center ~(0.32, 0.42) radius ~0.12; camera outside at (0.65, 0.5)
        scene=SceneSpec(bodies=(_blob(3965, (0.2, 0.3), (0.1, 0.1), BLUE),)),
        width=256,
        height=256,
        history=384,
        cam_pos=(0.65, 0.5),
        # small image -> few view cells -> dense bins: pre-size capacity so
        # the diagnostics adaptation doesn't need a startup recompile
        # (drop-free at 256 for this scene)
        render=RenderParams(bin_capacity=256),
    )


def config_two_body_collision() -> EngineConfig:
    """BASELINE config 2: two colliding softbodies at relativistic closing
    speed, 512x512, retarded-time visibility on (the reference demo scene
    geometry, twoplusone/mod.rs:86-113, at testimg3 scale per body)."""
    return EngineConfig(
        scene=SceneSpec(
            bodies=(
                _blob(4000, (0.30, 0.30), (0.25, 0.25), BLUE),
                _blob(4000, (0.95, 0.85), (-0.25, -0.25), RED),
            )
        ),
        width=512,
        height=512,
        history=512,
        cam_pos=(0.65, 0.6),
        # pre-sized bins (mid-size views run dense; avoids the
        # diagnostics adaptation's startup recompile)
        render=RenderParams(bin_capacity=128),
    )


def config_flagship_1080p() -> EngineConfig:
    """BASELINE config 3 (headline bench): 10k-particle softbody, 1080p, full
    Doppler + aberration shading, long worldline history."""
    return EngineConfig(
        scene=SceneSpec(
            bodies=(
                _blob(5000, (0.35, 0.40), (0.45, 0.1), BLUE),
                _blob(5000, (1.05, 0.55), (-0.45, -0.1), RED),
            )
        ),
        # bin_capacity 128: at 64 the scene drops ~150 candidates from full
        # view bins by frame 30 and the engine doubles it (recompile), so
        # it starts at the adapted size.
        # entry_budget 131072: 111k valid splat entries counted at frame
        # 120 — the slice keeps the binning off the full 4*pair_budget
        # rows; the engine doubles it on entry_dropped evidence
        render=RenderParams(num_rays=4096, pair_budget=32768,
                            bin_capacity=128, entry_budget=131072),
        width=1920,
        height=1080,
        history=1024,
        cam_pos=(0.7, 0.5),
        cam_zoom=1.2,
    )


def config_reference_demo() -> EngineConfig:
    """The upstream's default demo scene at its particle count (115,960):
    testimg4 at (0, 0) with velocity (0.1, 0.1) and testimg5 at (1.2, 0.8)
    with (-0.1, -0.1) (reference: src/twoplusone/mod.rs:86-113), here as
    procedural discs of the images' 57,980 lit pixels each (the PNGs are not
    part of this repository; tools/refdemo.py loads them when present),
    rendered retarded at 1080p.

    Render budgets: band=4 covers radial speeds to ~0.4c (the bodies close
    at 0.28c; RenderDiag.band_truncated guards it); splat_cells=4 is exact
    here (reach 4.9 px <= half a 16 px cell); pair_budget 262144 and
    entry_budget 524288 hold the ~130k valid crossings and their ~360k
    splat entries with headroom (RenderDiag.pairs_used / entry_dropped
    guard them); retina_budget 8192 holds the ~2.5k boundary pairs;
    bin_capacity 128 keeps the densest view bins drop-free (96 dropped a few
    candidates)."""
    return EngineConfig(
        scene=SceneSpec(
            bodies=(
                _blob(57980, (0.0, 0.0), (0.1, 0.1), BLUE),
                _blob(57980, (1.2, 0.8), (-0.1, -0.1), RED),
            )
        ),
        render=RenderParams(
            num_rays=4096, pair_budget=262144, entry_budget=524288,
            bin_capacity=128, band=4, splat_cells=4, retina_budget=8192,
        ),
        width=1920,
        height=1080,
        history=1024,
        cam_pos=(0.6, 0.4),
        cam_zoom=2.0,
    )


def config_accelerated_camera() -> EngineConfig:
    """BASELINE config 4: accelerated (Rindler) camera sweep over a
    multi-body scene; beaming + headlight effect."""
    return EngineConfig(
        scene=SceneSpec(
            bodies=(
                _blob(2000, (0.30, 0.35), (0.0, 0.15), BLUE),
                _blob(2000, (0.75, 0.55), (0.0, -0.15), RED),
                _blob(2000, (0.50, 0.80), (0.15, 0.0), (0.3, 0.9, 0.4)),
            )
        ),
        width=512,
        height=512,
        history=512,
        cam_pos=(0.2, 0.5),
        cam_vel=(0.0, 0.0),
        cam_accel=(0.5, 0.0),  # proper acceleration, c/s
        # pre-sized bins (mid-size views run dense; avoids the
        # diagnostics adaptation's startup recompile)
        render=RenderParams(bin_capacity=128),
    )


def config_boosted_observer() -> EngineConfig:
    """Camera-frame (boosted) map view: a fast camera flies between two
    blobs; the view plots every past-cone event in the camera's
    INSTANTANEOUS REST FRAME (ops/boost.py — the reference's archived
    observer-frame `Perspective` intent, object_archive.txt:20-99).
    Approaching matter appears stretched away (gamma*(1+v) radially ahead),
    receding matter compressed — the classical retarded-observer picture."""
    return EngineConfig(
        scene=SceneSpec(
            bodies=(
                _blob(3000, (0.55, 0.30), (0.0, 0.0), BLUE),
                _blob(3000, (0.05, 0.55), (0.0, 0.0), RED),
            )
        ),
        width=512,
        height=512,
        history=512,
        cam_pos=(0.25, 0.5),
        cam_vel=(0.5, 0.0),
        # bin_capacity pre-sized 256: the warped splat's stretched reach
        # densifies bins (measured: 128 adapts to 256 at frame ~180)
        render=RenderParams(bin_capacity=256, camera_frame=True),
    )


def config_conical_defect() -> EngineConfig:
    """BASELINE config 5 (stretch): curved 2+1 spacetime — geodesic rays
    around a conical-defect mass (see ops.curved)."""
    return EngineConfig(
        scene=SceneSpec(
            bodies=(
                _blob(3000, (0.25, 0.50), (0.0, 0.3), BLUE),
                _blob(3000, (0.75, 0.50), (0.0, -0.3), RED),
            )
        ),
        width=512,
        height=512,
        history=512,
        cam_pos=(0.5, 0.1),  # off the defect: geodesic routes degenerate at r=0
        render_mode="conical",
        defect=((0.5, 0.55), 1.2),
    )


def config_plastic_collision() -> EngineConfig:
    """Plastic vs elastic collision (round-3 materials stretch): the blue
    blob creeps (permanent deformation: it stays dented after impact), the
    red one is elastic.  Per-bond rest-length state, ops/forces
    creep_rest_lengths_shifted."""
    return EngineConfig(
        scene=SceneSpec(
            bodies=(
                _blob(3000, (0.30, 0.50), (0.12, 0.0), BLUE),
                _blob(3000, (0.70, 0.50), (-0.12, 0.0), RED),
            ),
            material_indices=(0, 1),
        ),
        width=512,
        height=512,
        history=384,
        cam_pos=(0.5, 0.5),
        render=RenderParams(bin_capacity=128),
        # blue: creeping solder-like material; red: stiff elastic
        materials=((1.0, 25.0, 1.0, 25.0, 0.10), (1.0, 10.0, 1.0)),
    )


def config_png_demo() -> EngineConfig:
    """The reference's ACTUAL demo path end-to-end: PNG blobs imported via
    image_to_softbody on a collision course (reference:
    src/twoplusone/mod.rs:86-113 loads testimg4/testimg5 the same way;
    fixtures here are small procedural stand-in blobs)."""
    import os

    fx = os.path.join(
        os.path.dirname(__file__), "..", "..", "assets", "fixtures"
    )
    return EngineConfig(
        scene=SceneSpec(
            bodies=(
                ("image", os.path.join(fx, "blob_a.png"),
                 (0.25, 0.30), (0.12, 0.12), BLUE),
                ("image", os.path.join(fx, "blob_b.png"),
                 (0.62, 0.58), (-0.12, -0.12), RED),
            )
        ),
        width=384,
        height=384,
        history=384,
        cam_pos=(0.55, 0.55),
        cam_zoom=0.9,
        # pre-sized bins (mid-size views run dense; avoids the
        # diagnostics adaptation's startup recompile)
        render=RenderParams(bin_capacity=128),
    )


def config_rindler_horizon() -> EngineConfig:
    """Rindler-horizon demo: a camera under constant proper acceleration
    a = 2 c/s has an event horizon c^2/a = 0.5 ls BEHIND it — light from
    events beyond it never catches up, so the trailing blob's image freezes
    at a finite retarded time while the leading blob stays live.  This drops
    out of the retarded renderer for free (events outside the camera's past
    light cone simply never satisfy the crossing); this config makes it a
    first-class scenario (ROADMAP round-1; no reference analog)."""
    return EngineConfig(
        scene=SceneSpec(
            bodies=(
                # trailing blob: starts 0.8 ls behind -> beyond the horizon
                _blob(1500, (-0.45, 0.42), (0.0, 0.0), RED),
                # leading blob: ahead of the camera, stays visible
                _blob(1500, (0.85, 0.42), (0.0, 0.0), BLUE),
            )
        ),
        width=512,
        height=256,
        history=768,  # long history: the frozen image stays renderable
        cam_pos=(0.45, 0.5),
        cam_zoom=2.4,  # frame both blobs: view spans x in [-0.75, 1.65]
        cam_accel=(2.0, 0.0),
        # zoom 2.4 packs ~0.01 ls into each view cell: the densest bins of
        # any named config (drop-free at 384, measured)
        render=RenderParams(bin_capacity=384),
    )


def config_btz_hole() -> EngineConfig:
    """BTZ black hole (the other half of BASELINE config 5's stretch):
    closed-form hyperbolic null geodesics, gravitational time delay, double
    images, black horizon disc (ops/btz.py)."""
    return EngineConfig(
        scene=SceneSpec(
            bodies=(
                _blob(3000, (0.25, 0.50), (0.0, 0.3), BLUE),
                _blob(3000, (0.75, 0.50), (0.0, -0.3), RED),
            )
        ),
        width=512,
        height=512,
        history=512,
        cam_pos=(0.5, 0.08),
        render_mode="btz",
        # ads_l ~ the scene scale so the lapse f = r^2/l^2 - M is O(1) where
        # the bodies live (with l >> scene, f << 1 makes coordinate light
        # crawl and every retarded image falls outside the stored history —
        # and flat-chart physics at 0.3c would outrun local light).
        # r_h = 0.45 sqrt(0.03) = 0.078 (a ~40 px disc at this zoom); blobs
        # stay >= 0.14 ls outside it for the whole vertical pass.
        btz=((0.5, 0.5), 0.03, 0.45),
    )


def config_btz_reflected() -> EngineConfig:
    """BTZ with AdS boundary-reflected routes (ops/btz.py ROUTES): light
    reaches the conformal boundary in finite coordinate time and bounces
    back, so every emitter gains boundary-ECHO images at the bounce delay
    (~230-450 ticks at this geometry, l/(2 sqrt(M)) ln-legs both ends).
    History must reach past the bounce delay or the echoes have no stored
    worldline to sample."""
    base = config_btz_hole()
    return dataclasses.replace(
        base,
        render=dataclasses.replace(base.render, btz_reflections=True),
        history=768,
    )


def config_btz_spinning() -> EngineConfig:
    """Rotating BTZ (slow-rotation frame dragging): co-rotating images
    arrive earlier than counter-rotating ones, so the double images of the
    same emitter split asymmetrically in time.  J = 0.004 is ~30% of the
    extremal J = M l = 0.0135 — well inside the O(J^2) model envelope
    (ops/btz.py BTZBlackHole; oracle-tested in tests/test_btz.py)."""
    return dataclasses.replace(
        config_btz_hole(), btz=((0.5, 0.5), 0.03, 0.45, 0.004))


def config_btz_extremal() -> EngineConfig:
    """Near-extremal rotating BTZ (J = 89% of M l) rendered with the EXACT
    rotating-metric solver (ops/btz_exact.py; the slow-rotation model's
    O(J^2) error is no longer negligible here).  Frame dragging at this
    spin visibly skews the co-/counter-rotating image pair."""
    base = config_btz_hole()
    return dataclasses.replace(
        base,
        btz=((0.5, 0.5), 0.03, 0.45, 0.012),
        render=dataclasses.replace(base.render, btz_exact_spin=True),
    )


def config_btz_photon_ring() -> EngineConfig:
    """BTZ with winding-1 routes: photon-ring-class images that circle the
    hole once before reaching the camera (~700-850 ticks extra delay at
    this geometry — the history must reach past it)."""
    base = config_btz_hole()
    return dataclasses.replace(
        base,
        render=dataclasses.replace(base.render, btz_windings=1),
        history=1024,
    )


def config_worldline3d() -> EngineConfig:
    """3D spacetime view of a two-body collision: the worldline ring drawn
    as an (x, y, t) block seen side-on (the reference's worldline3d.glsl
    intent, ops/worldline3d.py).  The blobs' past worldlines braid around
    the impact; shell_only draws the boundary tube."""
    return EngineConfig(
        scene=SceneSpec(
            bodies=(
                _blob(2000, (0.32, 0.50), (0.2, 0.0), BLUE),
                _blob(2000, (0.68, 0.50), (-0.2, 0.0), RED),
            )
        ),
        width=512,
        height=512,
        history=512,
        cam_pos=(0.5, 0.5),
        cam_zoom=1.1,
        render_mode="worldline3d",
        wl3d=Worldline3DParams(time_scale=0.45, fade=0.75, max_age=384),
    )


def config_selfgravity() -> EngineConfig:
    """Matter-sourced gravity (ops/gravity.py): each blob sources its own
    conical defect at its relativistic-energy centroid, deficit derived
    from the energy via defect_G — the lensing follows the matter through
    the collision, and with defect_retarded the geometry change itself
    propagates at c along the stored centroid track."""
    return EngineConfig(
        scene=SceneSpec(
            bodies=(
                _blob(3000, (0.30, 0.50), (0.25, 0.0), BLUE),
                _blob(3000, (0.70, 0.50), (-0.25, 0.0), RED),
            )
        ),
        width=512,
        height=512,
        history=512,
        cam_pos=(0.5, 0.32),  # off the collision axis: routes stay regular
        render_mode="conical",
        # derived deficits: 8*pi*G*E ~ 1.0 rad per blob at rest
        # (E ~ 3000 particles x 1.0 rest mass; gamma(0.25c) adds ~3%)
        defect_source=((0, None), (1, None)),
        defect_G=1.0 / (8.0 * 3.14159265 * 3000.0),
        defect_retarded=True,
    )


CONFIGS = {
    "single_blob": config_single_blob,
    "worldline3d": config_worldline3d,
    "btz_hole": config_btz_hole,
    "btz_reflected": config_btz_reflected,
    "btz_spinning": config_btz_spinning,
    "btz_extremal": config_btz_extremal,
    "btz_photon_ring": config_btz_photon_ring,
    "png_demo": config_png_demo,
    "two_body_collision": config_two_body_collision,
    "flagship_1080p": config_flagship_1080p,
    "reference_demo": config_reference_demo,
    "accelerated_camera": config_accelerated_camera,
    "boosted_observer": config_boosted_observer,
    "conical_defect": config_conical_defect,
    "selfgravity": config_selfgravity,
    "plastic_collision": config_plastic_collision,
    "rindler_horizon": config_rindler_horizon,
}


def get_config(name: str) -> EngineConfig:
    if name not in CONFIGS:
        raise KeyError(f"unknown config {name!r}; choose from {sorted(CONFIGS)}")
    return dataclasses.replace(CONFIGS[name](), name=name)
