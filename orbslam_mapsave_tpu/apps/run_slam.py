"""Dataset-driven SLAM main — the reference's example executables as one CLI.

Covers the reference entry points (`Examples/*.cc*`, SURVEY.md §2.1 L8):
- `Monocular_LoadImages.cpp` (TUM rgb.txt dataset, mono)
- `RGBD_LoadImages.cpp` / `RGBDFast_LoadImages.cpp` (TUM RGB-D dataset)
- `Monocular.cc` / `RGBD.cpp` / `RGBD_RTSP.cpp` live sources map to
  `ImageDirSource` (offline directory stream; this environment has no
  cameras).

Usage:
    python -m orbslam_mapsave_tpu.apps.run_slam --settings Setting.yaml
    python -m orbslam_mapsave_tpu.apps.run_slam --dataset /path/to/tum \
        --sensor rgbd --camera-yaml ORB_RGBD640x480.yaml --out traj.txt

Honors the master Setting.yaml cascade (`Examples/Setting.yaml`): vocabulary
path, camera settings path, reuse-map flag + path, viewer flag.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path


def main(argv=None):
    """Run the CLI; returns the (shut down) SLAMSystem for inspection."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--settings", help="master Setting.yaml (reference format)")
    ap.add_argument("--camera-yaml", help="camera/ORB settings yaml")
    ap.add_argument("--dataset", help="TUM/KITTI/imagedir dataset root")
    ap.add_argument("--sensor", choices=["mono", "rgbd", "stereo"],
                    default="rgbd")
    ap.add_argument("--vocabulary", help=".bin/.txt vocabulary path")
    ap.add_argument("--reuse-map", help="map checkpoint to load (reuse mode)")
    ap.add_argument("--save-map", help="map checkpoint to write at the end")
    ap.add_argument("--out", default="CameraTrajectory.txt")
    ap.add_argument("--kf-out", default="KeyFrameTrajectory.txt")
    ap.add_argument("--viewer-dir", help="write frame/map snapshots here")
    ap.add_argument("--html-view", help="write an interactive HTML map view "
                    "here at the end (orbit/zoom/pan in any browser)")
    ap.add_argument("--html-live", type=int, default=0, metavar="N_KFS",
                    help="LIVE map window: rewrite --html-view every N new "
                    "keyframes during the run; the page auto-refreshes, "
                    "so a browser pointed at it approximates the "
                    "reference's live viewer (costs one map fetch per "
                    "rewrite)")
    ap.add_argument("--max-frames", type=int, default=0)
    ap.add_argument("--follow", action="store_true",
                    help="treat --dataset as a GROWING directory (live-"
                    "sensor stand-in): poll for new frames, drop backlog, "
                    "stop after --follow-timeout idle seconds")
    ap.add_argument("--follow-timeout", type=float, default=5.0)
    args = ap.parse_args(argv)

    from .. import config as config_mod
    from ..io import dataset as dataset_mod
    from ..pipeline import system as system_mod

    if args.settings:
        cfg = config_mod.load_master_settings(args.settings)
    else:
        cfg = config_mod.SystemConfig()
    if args.camera_yaml:
        config_mod.load_camera_settings(args.camera_yaml, cfg)
    if args.reuse_map:
        cfg.reuse_map, cfg.reuse_map_path = True, args.reuse_map
    if args.vocabulary:
        cfg.vocabulary_path = args.vocabulary
    dataset_root = args.dataset or cfg.load_image_path

    voc = None
    if cfg.vocabulary_path and Path(cfg.vocabulary_path).is_file():
        from ..vocab import vocabulary as voc_mod

        print(f"Loading vocabulary {cfg.vocabulary_path} ...")
        t0 = time.time()
        voc = voc_mod.load(cfg.vocabulary_path)
        print(f"Vocabulary loaded ({voc.n_words} words) in {time.time()-t0:.2f}s")

    sensor = {"mono": system_mod.Sensor.MONOCULAR,
              "stereo": system_mod.Sensor.STEREO,
              "rgbd": system_mod.Sensor.RGBD}[args.sensor]
    slam = system_mod.SLAMSystem(
        cfg, sensor, vocabulary=voc,
        reuse_map_path=cfg.reuse_map_path if cfg.reuse_map else None,
    )
    viewer = None
    if args.viewer_dir or cfg.use_viewer or (args.html_live
                                             and args.html_view):
        from ..viz.viewer import Viewer

        viewer = Viewer(
            slam, cfg.viewer, args.viewer_dir or "viewer_out",
            # PNG snapshots only when a viewer dir was asked for
            every_n=10 if (args.viewer_dir or cfg.use_viewer) else 10**9,
            live_html=args.html_view if args.html_live else None,
            live_every_kfs=max(args.html_live, 1),
        )

    t_track = []
    if args.follow:
        if sensor == system_mod.Sensor.STEREO:
            raise SystemExit("--follow supports mono/rgbd directories")
        src = dataset_mod.FollowSource(
            dataset_root, depth_factor=cfg.camera.depth_map_factor,
            fps=cfg.camera.fps, idle_timeout=args.follow_timeout)
        print(f"Following {dataset_root} ({args.sensor}) — waiting for "
              f"frames, idle timeout {args.follow_timeout}s ...")
        for i, (t, gray, depth) in enumerate(src.frames()):
            t0 = time.perf_counter()
            if sensor == system_mod.Sensor.RGBD:
                pose = slam.track_rgbd(gray, depth, t)
            else:
                pose = slam.track_monocular(gray, t)
            t_track.append(time.perf_counter() - t0)
            if viewer is not None:
                viewer.update(gray, slam.tracker.last_frame, pose)
            if i % 30 == 0:
                state = ["WAIT", "INIT", "OK", "LOST"][slam.tracking_state]
                print(f"  frame {i}: {state} kfs={slam.n_keyframes} "
                      f"pts={slam.n_points} dropped={src.n_dropped}",
                      file=sys.stderr)
            if args.max_frames and src.n_seen >= args.max_frames:
                break
        print(f"follow ended: {src.n_seen} frames tracked, "
              f"{src.n_dropped} dropped (backlog policy)")
    else:
        ds = dataset_mod.open_dataset(
            dataset_root, depth_factor=cfg.camera.depth_map_factor)
        n = len(ds) if not args.max_frames else min(len(ds), args.max_frames)
        print(f"Tracking {n} frames from {dataset_root} ({args.sensor}) ...")
        for i in range(n):
            if sensor == system_mod.Sensor.STEREO:
                t, gray, right = ds.stereo(i)
            else:
                t, gray, depth = ds[i]
            t0 = time.perf_counter()
            if sensor == system_mod.Sensor.RGBD:
                pose = slam.track_rgbd(gray, depth, t)
            elif sensor == system_mod.Sensor.STEREO:
                pose = slam.track_stereo(gray, right, t)
            else:
                pose = slam.track_monocular(gray, t)
            t_track.append(time.perf_counter() - t0)
            if viewer is not None:
                viewer.update(gray, slam.tracker.last_frame, pose)
            if i % 30 == 0:
                state = ["WAIT", "INIT", "OK", "LOST"][slam.tracking_state]
                print(f"  frame {i}: {state} kfs={slam.n_keyframes} "
                      f"pts={slam.n_points} ({1e3*t_track[-1]:.0f} ms)",
                      file=sys.stderr)

    import numpy as np

    if t_track:
        print(f"median track time: {1e3*float(np.median(t_track)):.1f} ms "
              f"({1.0/float(np.median(t_track)):.1f} fps)")
    slam.save_camera_trajectory(args.out)
    slam.save_keyframe_trajectory(args.kf_out)
    print(f"trajectories saved to {args.out}, {args.kf_out}")
    if args.save_map:
        slam.save_map(args.save_map)
        print(f"map saved to {args.save_map}")
    if args.html_view:
        from ..viz import html_viewer
        import numpy as _np

        traj = [_np.linalg.inv(p) for _, p, lost in slam.tracker.trajectory
                if not lost]
        html_viewer.export_html(
            slam.map, args.html_view,
            trajectory=_np.asarray(traj) if traj else None)
        print(f"interactive map view written to {args.html_view}")
    slam.shutdown()
    return slam


if __name__ == "__main__":
    main()
