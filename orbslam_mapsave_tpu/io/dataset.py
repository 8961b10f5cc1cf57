"""Dataset loaders: TUM RGB-D, KITTI odometry mono, plus image-dir streams.

Mirrors the reference's dataset entry points:
- TUM-style `rgb.txt` lists read by `Examples/Monocular_LoadImages.cpp:151`
  (`LoadImages`: skip 3-line header, parse ``timestamp filename`` pairs) and
  the RGB-D variants (`RGBD_LoadImages.cpp`) which additionally read
  `depth.txt` and an `associate.txt`.
- Live-source mains (`Monocular.cc` V4L, `RGBD_RTSP.cpp`) are covered by
  `ImageDirSource`, the offline equivalent.

Images load in STORAGE dtype — uint8 grayscale, float16 depth-in-meters —
and the frame builder converts to float32 on device, so the host->device
copy carries a quarter of the bytes of an f32 pair.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Iterator

import numpy as np

from . import png


@dataclasses.dataclass
class FrameRecord:
    timestamp: float
    rgb_path: str | None = None
    depth_path: str | None = None


def _imread_gray(path: str | Path) -> np.ndarray:
    if Path(path).suffix.lower() != ".png":
        # JPEG frames of image-directory streams: an imaging library is
        # needed only for them
        from PIL import Image

        return np.asarray(Image.open(path).convert("L"))
    img = png.read(path)
    if img.ndim == 3:  # RGB(A) -> luma, ITU-R 601-2 weights (cv::cvtColor)
        img = img[..., :3].astype(np.float32) @ np.float32([0.299, 0.587,
                                                           0.114])
        return np.clip(np.rint(img), 0, 255).astype(np.uint8)
    if img.dtype == np.uint16:
        return (img >> 8).astype(np.uint8)
    return img


def _imread_depth(path: str | Path, depth_factor: float) -> np.ndarray:
    """TUM depth png: uint16, meters = value / DepthMapFactor
    (`src/Tracking.cc:238-241,379`). Shipped as f16 meters (quantization
    ~4mm at 4m, below Kinect sensor noise)."""
    arr = png.read(path).astype(np.float32)
    if depth_factor not in (0.0, 1.0):
        arr = arr / depth_factor
    return arr.astype(np.float16)


def read_tum_list(path: str | Path) -> list[tuple[float, str]]:
    """Parse a TUM rgb.txt/depth.txt: '# comment' lines then 't path'."""
    out = []
    for line in Path(path).read_text().splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        t, p = line.split()[:2]
        out.append((float(t), p))
    return out


def associate(rgb: list[tuple[float, str]], depth: list[tuple[float, str]],
              max_dt: float = 0.02) -> list[FrameRecord]:
    """Greedy nearest-timestamp association of rgb to depth (TUM tooling)."""
    recs = []
    dts = np.array([t for t, _ in depth])
    for t, rp in rgb:
        j = int(np.abs(dts - t).argmin())
        if abs(dts[j] - t) <= max_dt:
            recs.append(FrameRecord(t, rp, depth[j][1]))
    return recs


class TUMDataset:
    """TUM RGB-D sequence directory: rgb.txt [+ depth.txt]."""

    def __init__(self, root: str | Path, depth_factor: float = 5000.0):
        self.root = Path(root)
        self.depth_factor = depth_factor
        rgb = read_tum_list(self.root / "rgb.txt")
        depth_file = self.root / "depth.txt"
        if depth_file.is_file():
            self.records = associate(rgb, read_tum_list(depth_file))
        else:
            self.records = [FrameRecord(t, p) for t, p in rgb]
        gt = self.root / "groundtruth.txt"
        self.groundtruth_path = gt if gt.is_file() else None

    def __len__(self) -> int:
        return len(self.records)

    def __getitem__(self, i: int) -> tuple[float, np.ndarray, np.ndarray | None]:
        r = self.records[i]
        gray = _imread_gray(self.root / r.rgb_path)
        depth = (
            _imread_depth(self.root / r.depth_path, self.depth_factor)
            if r.depth_path
            else None
        )
        return r.timestamp, gray, depth

    def __iter__(self) -> Iterator[tuple[float, np.ndarray, np.ndarray | None]]:
        for i in range(len(self)):
            yield self[i]


class KITTIDataset:
    """KITTI odometry grayscale sequence: image_0/??????.png + times.txt.

    If an `image_1/` directory exists the sequence is stereo-capable
    (`has_stereo`); `stereo(i)` returns the left/right pair for
    `System::TrackStereo` (`src/System.cc:261-334`)."""

    def __init__(self, root: str | Path):
        self.root = Path(root)
        self.times = [
            float(line)
            for line in (self.root / "times.txt").read_text().split()
            if line.strip()
        ]
        self.images = sorted((self.root / "image_0").glob("*.png"))
        self.images_r = sorted((self.root / "image_1").glob("*.png"))
        self.has_stereo = len(self.images_r) == len(self.images) > 0

    def __len__(self) -> int:
        return min(len(self.times), len(self.images))

    def __getitem__(self, i: int) -> tuple[float, np.ndarray, None]:
        return self.times[i], _imread_gray(self.images[i]), None

    def stereo(self, i: int) -> tuple[float, np.ndarray, np.ndarray]:
        if not self.has_stereo:
            raise ValueError(
                f"{self.root} has no image_1/ directory (stereo requires "
                "image_0/ + image_1/ with matching frame counts)"
            )
        return (self.times[i], _imread_gray(self.images[i]),
                _imread_gray(self.images_r[i]))

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]


class ImageDirSource:
    """Offline stand-in for the reference's live V4L/RTSP sources
    (`Examples/Monocular.cc:58-61`): any directory of images at a fixed fps."""

    def __init__(self, root: str | Path, fps: float = 30.0):
        self.paths = sorted(
            p for p in Path(root).iterdir() if p.suffix.lower() in (".png", ".jpg", ".jpeg")
        )
        self.fps = fps

    def __len__(self):
        return len(self.paths)

    def __getitem__(self, i):
        return i / self.fps, _imread_gray(self.paths[i]), None

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]


class FollowSource:
    """Follow a directory that GROWS while the system runs — this
    environment's stand-in for the reference's live V4L / RealSense / RTSP
    mains (`Examples/Monocular.cc:65-132`, `Examples/RGBD.cpp:69-100`).

    Layout: flat images, or `rgb/` (+ `depth/` with identical filenames
    for RGB-D — an rgb file only counts as available once its depth twin
    exists). Timestamps parse from numeric filename stems (TUM style),
    falling back to arrival_index / fps.

    Frame-drop policy (live-camera grab semantics): when the tracker falls
    behind and several new files have appeared since the last poll, only
    the NEWEST is processed and the backlog is dropped (counted in
    `n_dropped`) — a per-frame live main also only ever sees the latest
    grabbed frame, and the reference paces itself the same way
    (`mMaxFrames` keyframe pacing, `src/Tracking.cc:163-174`).

    The generator ends after `idle_timeout` seconds without a new file.
    """

    EXTS = (".png", ".jpg", ".jpeg")

    def __init__(self, root: str | Path, depth_factor: float = 5000.0,
                 fps: float = 30.0, idle_timeout: float = 5.0,
                 poll_interval: float = 0.02, drop_stale: bool = True):
        self.root = Path(root)
        self.depth_factor = depth_factor
        self.fps = fps
        self.idle_timeout = idle_timeout
        self.poll_interval = poll_interval
        self.drop_stale = drop_stale
        self.n_dropped = 0
        self.n_seen = 0

    def _rgb_dir(self) -> Path:
        d = self.root / "rgb"
        return d if d.is_dir() else self.root

    def _depth_dir(self) -> Path | None:
        d = self.root / "depth"
        return d if d.is_dir() else None

    @staticmethod
    def _stamp(path: Path, idx: int, fps: float) -> float:
        try:
            return float(path.stem)
        except ValueError:
            return idx / fps

    def frames(self):
        import time as _time

        seen: set[str] = set()
        last_new = _time.monotonic()
        while True:
            rgb_dir = self._rgb_dir()
            depth_dir = self._depth_dir()
            fresh = sorted(
                p for p in rgb_dir.iterdir()
                if p.suffix.lower() in self.EXTS and p.name not in seen
                and (depth_dir is None or (depth_dir / p.name).is_file())
            ) if rgb_dir.is_dir() else []
            if not fresh:
                if _time.monotonic() - last_new > self.idle_timeout:
                    return
                _time.sleep(self.poll_interval)
                continue
            last_new = _time.monotonic()
            for p in fresh:
                seen.add(p.name)
            batch = fresh[-1:] if self.drop_stale else fresh
            self.n_dropped += len(fresh) - len(batch)
            for p in batch:
                t = self._stamp(p, self.n_seen + self.n_dropped, self.fps)
                gray = _imread_gray(p)
                depth = (_imread_depth(depth_dir / p.name, self.depth_factor)
                         if depth_dir is not None else None)
                self.n_seen += 1
                yield t, gray, depth


def open_dataset(root: str | Path, depth_factor: float = 5000.0):
    root = Path(root)
    if (root / "rgb.txt").is_file():
        return TUMDataset(root, depth_factor)
    if (root / "times.txt").is_file():
        return KITTIDataset(root)
    return ImageDirSource(root)
