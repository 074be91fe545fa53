"""Video frame extraction for the offline corpus pipeline, on the host
(counterpart of merlot_tpu/data/video.py).

Two routes, the same frames:
  * ffmpeg, when the binary is on the PATH: one process per frame, seeking
    to the timestamp (``-ss t -frames:v 1 -q:v 2 -pix_fmt rgb24``, raw RGB
    on stdout), four at a time; ``ffprobe`` reads the frame size;
  * OpenCV otherwise: one ``cv2.VideoCapture`` seeking by milliseconds
    (captures are not thread-safe; a corpus build runs videos side by side
    instead). cv2 is imported inside the functions only.
``frame_route()`` says which one runs. Black bars are trimmed from the
frames of a video together (at most 20% per side, by an intensity
threshold), and ``get_size_for_resize`` gives the stored size: the shorter
side 384 unless the longer would pass 512, never upscaled.
"""

from __future__ import annotations

import concurrent.futures
import shutil
import subprocess
from typing import List, Optional, Sequence, Tuple

import numpy as np


def ffmpeg_available() -> bool:
    return shutil.which("ffmpeg") is not None


def frame_route() -> str:
    """'ffmpeg' or 'cv2': the route the extraction functions take here."""
    return "ffmpeg" if ffmpeg_available() else "cv2"


# ----------------------------------------------------------------------
# the cv2 route
# ----------------------------------------------------------------------
def _cv2_extract_at_times(video_file: str, times: Sequence[float]
                          ) -> List[Optional[np.ndarray]]:
    """RGB frames at ``times`` (seconds) from one capture, None where a
    read fails (every entry when the file does not open)."""
    import cv2
    cap = cv2.VideoCapture(video_file)
    frames: List[Optional[np.ndarray]] = []
    try:
        if not cap.isOpened():
            return [None] * len(times)
        for t in times:
            cap.set(cv2.CAP_PROP_POS_MSEC, max(t, 0.0) * 1000.0)
            ok, bgr = cap.read()
            frames.append(bgr[..., ::-1].copy() if ok else None)
    finally:
        cap.release()
    return frames


def _cv2_extract_fixed_fps(video_file: str, fps: float) -> np.ndarray:
    """Frames at t = i / fps over the video's duration; raises on a
    dropped frame (frame i must stay at i / fps)."""
    import cv2
    cap = cv2.VideoCapture(video_file)
    try:
        if not cap.isOpened():
            raise RuntimeError(f"cv2 cannot open {video_file}")
        native_fps = cap.get(cv2.CAP_PROP_FPS) or 30.0
        n = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
        duration = n / native_fps if native_fps else 0.0
    finally:
        cap.release()
    times = np.arange(0.0, max(duration, 1.0 / max(fps, 1e-6)), 1.0 / fps)
    frames = _cv2_extract_at_times(video_file, list(times))
    missing = [i for i, f in enumerate(frames) if f is None]
    if missing:
        raise RuntimeError(f"cv2 failed to decode frames {missing[:5]}... of {video_file}")
    return np.stack(frames)


# ----------------------------------------------------------------------
# black bars and the stored size
# ----------------------------------------------------------------------
def detect_black_bars(frames: np.ndarray, blackbar_threshold: int = 16,
                      max_perc_to_trim: float = 0.2) -> Tuple[int, int, int, int]:
    """(y1, y2, x1, x2), the content box of [N, H, W, 3] frames: the rows
    and columns where some frame and channel reaches the threshold, trimmed
    by at most ``max_perc_to_trim`` of each side."""
    has_content = frames.max(axis=(0, -1)) >= blackbar_threshold
    h, w = has_content.shape

    def span(hit: np.ndarray, n: int) -> Tuple[int, int]:
        idx = np.where(hit)[0]
        if idx.size == 0:
            idx = np.array([n // 2])
        return (min(int(idx[0]), int(n * max_perc_to_trim)),
                max(int(idx[-1]) + 1, int(n * (1 - max_perc_to_trim))))

    y1, y2 = span(has_content.any(1), h)
    x1, x2 = span(has_content.any(0), w)
    return y1, y2, x1, x2


def _trim(frames: np.ndarray, blackbar_threshold: int, max_perc_to_trim: float) -> np.ndarray:
    y1, y2, x1, x2 = detect_black_bars(frames, blackbar_threshold, max_perc_to_trim)
    return frames[:, y1:y2, x1:x2]


def get_size_for_resize(image_size: Tuple[int, int], shorter_size_trg: int = 384,
                        longer_size_max: int = 512) -> Tuple[int, int]:
    """Target (w, h) for an image of (w, h): the shorter side to
    ``shorter_size_trg`` unless the longer side would pass
    ``longer_size_max`` (then the size that keeps it there); never
    upscaled."""
    w, h = image_size
    size = shorter_size_trg
    if min(w, h) <= size:
        return w, h
    if max(w, h) / min(w, h) * size > longer_size_max:
        size = int(round(longer_size_max * min(w, h) / max(w, h)))
    if (w <= h and w == size) or (h <= w and h == size):
        return w, h
    if w < h:
        return size, int(size * h / w)
    return int(size * w / h), size


# ----------------------------------------------------------------------
# extraction
# ----------------------------------------------------------------------
def _probe_size(video_file: str) -> Tuple[int, int]:
    """(width, height) of the first video stream, by ffprobe."""
    out = subprocess.run(
        ["ffprobe", "-v", "error", "-select_streams", "v:0",
         "-show_entries", "stream=width,height", "-of", "csv=p=0", video_file],
        capture_output=True, check=True, text=True).stdout.strip()
    w, h = (int(x) for x in out.split(",")[:2])
    return w, h


def extract_single_frame(video_file: str, t: float,
                         size: Optional[Tuple[int, int]] = None) -> Optional[np.ndarray]:
    """One RGB frame [H, W, 3] uint8 at timestamp t, or None. ``size`` (w,
    h) saves the ffmpeg route its probe."""
    if not ffmpeg_available():
        return _cv2_extract_at_times(video_file, [t])[0]
    w, h = size if size is not None else _probe_size(video_file)
    cmd = ["ffmpeg", "-ss", f"{t:.3f}", "-threads", "1", "-i", video_file,
           "-frames:v", "1", "-q:v", "2", "-f", "rawvideo",
           "-pix_fmt", "rgb24", "-v", "error", "pipe:1"]
    out = subprocess.run(cmd, capture_output=True).stdout
    if len(out) < w * h * 3:
        return None
    return np.frombuffer(out[:w * h * 3], np.uint8).reshape(h, w, 3)


def extract_frames_from_video(video_file: str, times: Sequence[float],
                              use_multithreading: bool = True,
                              blackbar_threshold: int = 32,
                              max_perc_to_trim: float = 0.2) -> Optional[np.ndarray]:
    """Frames at ``times`` with the black bars trimmed: [N, H', W', 3]
    uint8, or None if any frame failed. The ffmpeg route runs four frames
    at a time with ``use_multithreading``."""
    if not ffmpeg_available():
        frames = _cv2_extract_at_times(video_file, times)
    else:
        size = _probe_size(video_file)
        one = lambda t: extract_single_frame(video_file, t, size)
        if use_multithreading:
            with concurrent.futures.ThreadPoolExecutor(max_workers=4) as pool:
                frames = list(pool.map(one, times))
        else:
            frames = [one(t) for t in times]
    if any(f is None for f in frames):
        return None
    return _trim(np.stack(frames), blackbar_threshold, max_perc_to_trim)


def extract_all_frames(video_file: str, fps: float = 1.0, blackbar_threshold: int = 32,
                       max_perc_to_trim: float = 0.2) -> np.ndarray:
    """Every frame at a fixed rate (``fps``), black bars trimmed."""
    if not ffmpeg_available():
        frames = _cv2_extract_fixed_fps(video_file, fps)
    else:
        w, h = _probe_size(video_file)
        cmd = ["ffmpeg", "-i", video_file, "-vf", f"fps={fps}", "-q:v", "2",
               "-f", "rawvideo", "-pix_fmt", "rgb24", "-v", "error", "pipe:1"]
        out = subprocess.run(cmd, capture_output=True).stdout
        n = len(out) // (w * h * 3)
        frames = np.frombuffer(out[:n * w * h * 3], np.uint8).reshape(n, h, w, 3)
    return _trim(frames, blackbar_threshold, max_perc_to_trim)
