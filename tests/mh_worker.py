"""Multi-process worker: one JAX process of a 2-process CPU 'pod'.

Launched by tests/test_multihost.py (and usable standalone for debugging):

    python tests/mh_worker.py --id 0 --procs 2 --port 29541 --out /tmp/w0

Each worker joins the coordination service, builds the SAME deterministic
scene, places it on the 8-device global mesh (4 CPU devices per process),
runs one fused sharded frame, and checks the result against a
process-local single-device oracle.  Writes "OK ..." (or the failure) to
--out.  The launcher sets JAX_PLATFORMS=cpu in the worker env.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--id", type=int, required=True)
    ap.add_argument("--procs", type=int, default=2)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args()

    import jax

    from spacetime_tpu.parallel import multihost

    multihost.initialize(f"127.0.0.1:{args.port}", args.procs, args.id)
    assert jax.process_count() == args.procs, jax.process_count()
    assert jax.default_backend() == "cpu", jax.default_backend()

    import dataclasses

    import jax.numpy as jnp
    import numpy as np

    from spacetime_tpu import scene
    from spacetime_tpu.camera import Camera
    from spacetime_tpu.models.softbody import SoftbodyModel
    from spacetime_tpu.ops import raytrace
    from spacetime_tpu.ops import worldline as wl
    from spacetime_tpu.parallel import sharding

    # deterministic scene — every process builds identical host arrays
    capacity, history, w, h = 256, 32, 48, 48
    sb = scene.SceneBuilder()
    sb.add(scene.disc_softbody(3, 0, (0.45, 0.45), (0.1, 0.0)),
           base_color=(0, 0, 1))
    particles, objects = sb.build(capacity=capacity)
    model = SoftbodyModel(capacity=capacity)
    buf = wl.create(history, capacity)
    buf = wl.prefill_inertial(
        buf, particles.pos, particles.vel, particles.active,
        jnp.float32(0.0), jnp.float32(model.params.h),
    )
    buf = wl.push_frame(buf, particles, 0.0)
    params = raytrace.RenderParams(num_rays=128)
    params = dataclasses.replace(
        params, cell_px=raytrace.auto_cell_px(params, w, h, 0.5)
    )
    cam = Camera.create(pos=(0.5, 0.5), zoom=0.5)

    # process-local single-device oracle
    p1, _ = model.step(particles)
    b1 = wl.push_frame(buf, p1, model.params.h)
    img1 = np.asarray(raytrace.render_retarded(
        b1, p1.object_index, objects, cam, w, h, params
    ))
    assert (img1 < 0.999).any(), "oracle scene rendered all-white"

    # global mesh across both processes
    mesh = multihost.global_mesh()
    assert mesh.devices.size == 4 * args.procs, mesh.devices
    p_sh, b_sh = multihost.host_state(particles, buf, mesh)
    frame = sharding.make_sharded_frame(model, objects, params, w, h, mesh)
    p2, b2, img2 = frame(p_sh, b_sh, cam, jnp.float32(model.params.h))

    # the frame must really be cross-process sharded, not process-local
    assert not img2.is_fully_addressable, "frame did not span processes"

    img2_host = multihost.allgather(img2)
    pos2 = multihost.allgather(p2.pos)
    dimg = float(np.abs(img2_host - img1).max())
    dpos = float(np.abs(pos2 - np.asarray(p1.pos)).max())
    np.testing.assert_allclose(img2_host, img1, atol=1e-5)
    np.testing.assert_allclose(pos2, np.asarray(p1.pos), rtol=1e-6, atol=1e-7)

    multihost.sync("mh-worker-done")
    with open(args.out, "w") as f:
        f.write(f"OK dimg={dimg:.2e} dpos={dpos:.2e} "
                f"procs={jax.process_count()} devs={mesh.devices.size}\n")


if __name__ == "__main__":
    try:
        main()
    except Exception as exc:  # write the failure where the test can read it
        import traceback

        out = None
        for i, a in enumerate(sys.argv):
            if a == "--out" and i + 1 < len(sys.argv):
                out = sys.argv[i + 1]
        if out:
            with open(out, "w") as f:
                f.write(f"FAIL {type(exc).__name__}: {exc}\n")
                f.write(traceback.format_exc())
        raise
