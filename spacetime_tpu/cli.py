"""Command-line runner: headless frames, PNG dumps, stats, checkpoints.

The reference has no CLI (a hard-coded windowed demo, SURVEY.md §5); this is
the headless equivalent of its app loop plus the config system it lacked.

Usage:
    python -m spacetime_tpu --config single_blob --frames 60 --out frames
    python -m spacetime_tpu --config two_body_collision --frames 30 --stats
    python -m spacetime_tpu --config flagship_1080p --frames 10 --save ckpt.npz
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="spacetime_tpu", description=__doc__)
    ap.add_argument("--config", default="single_blob",
                    help="named config (see utils/config.py) ")
    ap.add_argument("--frames", type=int, default=30)
    ap.add_argument("--out", default=None, help="directory for PNG frames")
    ap.add_argument("--every", type=int, default=1, help="dump every Nth frame")
    ap.add_argument("--mode", default=None,
                    choices=[None, "retarded", "points", "instant", "retina",
                             "conical", "btz", "worldline3d"])
    ap.add_argument("--width", type=int, default=None)
    ap.add_argument("--height", type=int, default=None)
    ap.add_argument("--stats", action="store_true", help="print stats JSON")
    ap.add_argument("--stage-timing", action="store_true",
                    help="split dispatches + device syncs: true per-stage ms "
                         "in --stats (reference: querybank.rs timestamps)")
    ap.add_argument("--save", default=None, help="checkpoint path to write")
    ap.add_argument("--load", default=None, help="checkpoint path to resume")
    ap.add_argument("--cpu", action="store_true", help="force CPU backend")
    ap.add_argument("--realtime", action="store_true",
                    help="pace to max_fps (reference: main.rs:78-83)")
    ap.add_argument("--serve", type=int, default=None, metavar="PORT",
                    help="live MJPEG view at http://host:PORT/ (0 = any port; "
                         "the headless analog of the reference's native "
                         "window, native/streamsink.cpp)")
    ap.add_argument("--serve-bind", default="127.0.0.1", metavar="ADDR",
                    help="bind address for --serve (default loopback; the "
                         "stream has no auth — use 0.0.0.0 to expose it)")
    ap.add_argument("--overlay", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="draw the live stats panel on served frames "
                         "(reference: src/debugui.rs egui overlay); PNG "
                         "dumps via --out always stay raw")
    args = ap.parse_args(argv)

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    from .engine import Engine, save_png
    from .utils.config import get_config

    cfg = get_config(args.config)
    overrides = {}
    if args.mode:
        overrides["render_mode"] = args.mode
    if args.width:
        overrides["width"] = args.width
    if args.height:
        overrides["height"] = args.height
    if args.stage_timing:
        overrides["stage_timing"] = True
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)

    eng = Engine(cfg)
    if args.load:
        eng.load_checkpoint(args.load)

    on_frame = None
    sink = None
    stream = None
    if args.out or args.serve is not None:

        def on_frame(i, img):
            nonlocal sink, stream
            if i % args.every != 0:
                return
            import numpy as np

            arr = np.asarray(img)
            if args.out:
                from .utils.framesink import FrameSink

                if sink is None:  # sized from the actual frame (retina
                    # strips differ from the config's nominal W x H)
                    sink = FrameSink(args.out, arr.shape[1], arr.shape[0])
                sink.submit(i, arr)
            if args.serve is not None:
                from .utils.streamsink import StreamSink

                if stream is None:
                    stream = StreamSink(args.serve, arr.shape[1],
                                        arr.shape[0], bind=args.serve_bind)
                    # non-loopback binds get an auto key token — /key steers
                    # the engine, so the URL carries the shared secret
                    tok = f"?t={stream.key_token}" if stream.key_token else ""
                    print(f"# live view: http://{args.serve_bind}:{stream.port}/{tok}"
                          f" ({'native' if stream.native else 'python'})",
                          file=sys.stderr)
                if args.overlay:
                    from .utils.overlay import overlay_stats

                    arr = overlay_stats(arr, eng)
                stream.submit(arr)

    # keyboard events posted by the live-view page (GET /key) steer the
    # running engine: pan/zoom/pause/max-FPS/mode toggles — the reference's
    # interactive window (keyboard.rs + debugui.rs) for a headless host.
    # (The stream is created lazily on the first frame; poll once it exists.)
    key_source = None
    if args.serve is not None:
        key_source = lambda: stream.poll_keys() if stream is not None else []  # noqa: E731
    eng.run(args.frames, on_frame=on_frame, realtime=args.realtime,
            key_source=key_source)
    if args.stats and eng._can_fuse():
        # fused frames report no host-timed stage splits; capture device
        # stage attribution from a short profiled run of the same program
        eng.profile_stages()
    summary = eng.stats.summary()
    if sink is not None:
        sink.close()
    if stream is not None:
        stream.close()
    if args.save:
        eng.save_checkpoint(args.save)
    if args.stats or not args.out:
        print(json.dumps(summary, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
