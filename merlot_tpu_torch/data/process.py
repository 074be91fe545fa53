"""The offline corpus pipeline: (video, ASR, denoised transcript) ->
pretraining tfrecords (counterpart of merlot_tpu/data/process.py).

    python -m merlot_tpu_torch.data.process --videos a.mp4 b.mp4 --out shard.tfrecord

Each video needs ``<stem>.grover.json`` beside it, as the Grover denoiser
service writes it: 'subtitles' ([{word, time}]), 'denoised' ([{cleanasr}])
and 'info' ({id, title, duration}). Stages:
  1. subtitle cleanup: words like '&gt;' or 'x;' dropped, mojibake repaired
     (``fix_text``: ftfy where it imports, else the text as it is);
  2. description cleanup: emoji -> [name] (demoji where it imports), URLs
     -> '%', whitespace normalized;
  3. DTW alignment of the ASR words to the denoised words over a banded
     character edit-distance cost (radius max(10% of the length, 32)); each
     ASR word takes the denoised words its path visits first;
  4. greedy chunking into caption chunks of at most 31 tokens, ended early
     at a sentence end once 75% full;
  5. one frame per chunk at its mean time (``data/video.py``), resized
     bicubically to the stored size (shorter side 384, longer at most 512),
     JPEG quality 95, grouped 16 chunks to an example and written through a
     shuffle buffer.
The shards are what ``data/pretrain_loader.py`` and the pretraining CLI
read; on the same inputs they are the JAX package's bytes. PIL is imported
inside the functions that make frames only.
"""

from __future__ import annotations

import argparse
import hashlib
import io
import json
import random
import re
import string
import sys
import time
from typing import Any, Dict, Iterator, List, Optional, Sequence

import numpy as np

from merlot_tpu_torch.core.tokenizer import get_tokenizer
from merlot_tpu_torch.data.tfrecord import TFRecordWriter, encode_example

CHUNK_LEN = 31
STOP_THRESH = 0.75   # a chunk may end at a sentence end once this full
NUM_CHUNKS = 16

_PUNCT_TABLE = str.maketrans("", "", string.punctuation)
_URL_RE = re.compile(
    r"""(?i)\b((?:https?://|www\d{0,3}[.]|[a-z0-9.\-]+[.][a-z]{2,4}/)"""
    r"""(?:[^\s()<>]+|\(([^\s()<>]+|(\([^\s()<>]+\)))*\))+"""
    r"""(?:\(([^\s()<>]+|(\([^\s()<>]+\)))*\)|[^\s`!()\[\]{};:'".,<>?«»“”‘’]))""")


# ----------------------------------------------------------------------
# edit distance and the DTW path
# ----------------------------------------------------------------------
def edit_distance(a: str, b: str) -> int:
    """Levenshtein distance in characters."""
    if len(a) < len(b):
        a, b = b, a
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[-1] + 1, prev[j - 1] + (ca != cb)))
        prev = cur
    return prev[-1]


def dtw_path(cost: np.ndarray) -> List[tuple]:
    """The monotone path (0, 0) -> (n-1, m-1) of least summed cost with
    steps (i+1, j), (i, j+1), (i+1, j+1) (tslearn's ``dtw_path_from_metric``
    on a precomputed matrix); among equal predecessors the diagonal, then
    (i-1, j), then (i, j-1)."""
    n, m = cost.shape
    acc = np.full((n, m), np.inf, np.float64)
    acc[0, 0] = cost[0, 0]
    for i in range(n):
        for j in range(m):
            if i == 0 and j == 0:
                continue
            best = np.inf
            if i > 0:
                best = min(best, acc[i - 1, j])
            if j > 0:
                best = min(best, acc[i, j - 1])
            if i > 0 and j > 0:
                best = min(best, acc[i - 1, j - 1])
            acc[i, j] = cost[i, j] + best
    path = [(n - 1, m - 1)]
    i, j = n - 1, m - 1
    while (i, j) != (0, 0):
        options = []
        if i > 0 and j > 0:
            options.append((acc[i - 1, j - 1], (i - 1, j - 1)))
        if i > 0:
            options.append((acc[i - 1, j], (i - 1, j)))
        if j > 0:
            options.append((acc[i, j - 1], (i, j - 1)))
        _, (i, j) = min(options, key=lambda x: x[0])
        path.append((i, j))
    return path[::-1]


def align_using_dtw(input_asr: Sequence[str], grover_output: Sequence[str],
                    radius_perc: float = 0.1, radius_abs: int = 32) -> List[str]:
    """For each ASR word, the denoised words (space-joined) its DTW path
    visits first; no denoised word goes to two ASR words."""
    max_radius = int(max(len(input_asr) * radius_perc, radius_abs))
    grover_output = list(grover_output)[:len(input_asr) + max_radius]

    def prep(x: str) -> str:
        return x.translate(_PUNCT_TABLE).strip().lower()

    asr_pre = [prep(x) for x in input_asr]
    gro_pre = [prep(x) for x in grover_output]
    cost = np.full((len(asr_pre), len(gro_pre)), 9999.0, np.float32)
    for i, a in enumerate(asr_pre):
        for j in range(max(i - max_radius, 0), min(i + max_radius, len(gro_pre))):
            cost[i, j] = edit_distance(a, gro_pre[j])

    out: List[List[str]] = [[] for _ in input_asr]
    seen = -1
    for i, j in dtw_path(cost):
        if i >= len(input_asr) or j >= len(grover_output):
            break
        if j > seen:
            out[i].append(grover_output[j])
        seen = j
    return [" ".join(x) for x in out]


# ----------------------------------------------------------------------
# text cleanup
# ----------------------------------------------------------------------
def fix_text(text: str) -> str:
    """ftfy's repair where ftfy imports, else the text unchanged."""
    try:
        import ftfy
    except ImportError:
        return text
    return ftfy.ftfy(text)


def clean_subtitles(subtitle_dicts: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """The subtitles without '&...'/'...;' artifacts and empty words, each
    word through ``fix_text``."""
    out = []
    for x in subtitle_dicts:
        if x["word"].startswith("&") or x["word"].endswith(";"):
            continue
        fixed = fix_text(x["word"])
        if fixed:
            out.append({**x, "word": fixed})
    return out


def clean_description(text: str) -> str:
    """Emoji -> [name] (where demoji imports), URLs -> '%', runs of spaces
    and blank lines collapsed."""
    try:
        import demoji
    except ImportError:
        demoji = None
    if demoji is not None:
        for k, v in demoji.findall(text).items():
            text = text.replace(k, f"[{v}]".replace(" ", ""))
    text = _URL_RE.sub("%", text.strip())
    text = re.sub(" +", " ", text)
    text = re.sub(r"\s*\n+", "\n", text)
    return text.strip()


# ----------------------------------------------------------------------
# chunking
# ----------------------------------------------------------------------
def split_video_into_chunks(item: Dict[str, Any], tokenizer=None) -> List[Dict[str, Any]]:
    """Greedy chunks of the aligned transcript: each {'start', 'end' (word
    indices), 'clean_enc', 'noisy_enc' (token ids), 'is_eoc' (the last
    chunk), 'mean_timestep'}. A chunk ends when the next word would take
    either stream past CHUNK_LEN tokens, or at a sentence end once the
    clean stream is STOP_THRESH full; chunks whose mean time is not below
    the duration less one second are dropped. ``item`` needs 'subtitles',
    'denoised' and 'info' with a 'title'."""
    tokenizer = tokenizer or get_tokenizer()
    subs = clean_subtitles(item["subtitles"])
    if not subs:
        raise ValueError("no usable subtitles")
    if "title" not in item["info"]:
        raise ValueError("'title' not in item['info']")

    words = [x["word"] for x in subs]
    times = [x["time"] for x in subs]
    encoded = [tokenizer.encode(" " + w.strip()) for w in words]
    denoised_words: List[str] = []
    for x in item["denoised"]:
        denoised_words += fix_text(x["cleanasr"]).split(" ")
    denoised = align_using_dtw(words, denoised_words)
    denoised_enc = [tokenizer.encode(f" {x}") if x else [] for x in denoised]

    max_ts = item["info"].get("duration", 1000000) - 1.0
    chunks: List[Dict[str, Any]] = []
    start_idx = 0
    clean_buf: List[int] = []
    noisy_buf: List[int] = []
    n = len(words)
    for idx in range(n):
        clean_buf += denoised_enc[idx]
        noisy_buf += encoded[idx]
        commit = idx == n - 1
        if not commit:
            longest = max(len(noisy_buf) + len(encoded[idx + 1]),
                          len(clean_buf) + len(denoised_enc[idx + 1]))
            commit = longest > CHUNK_LEN or (
                denoised[idx].endswith((".", "?", "!"))
                and len(clean_buf) >= CHUNK_LEN * STOP_THRESH)
        if commit:
            mean_ts = (times[start_idx] + times[idx]) / 2.0
            if mean_ts < max_ts:
                chunks.append({"start": start_idx, "end": idx, "clean_enc": clean_buf,
                               "noisy_enc": noisy_buf, "is_eoc": False,
                               "mean_timestep": mean_ts})
            clean_buf, noisy_buf = [], []
            start_idx = idx + 1
    if not chunks:
        raise ValueError("chunks is empty")
    chunks[-1]["is_eoc"] = True
    return chunks


# ----------------------------------------------------------------------
# tfrecord writing
# ----------------------------------------------------------------------
class ShufflingTFRecordWriter:
    """A tfrecord writer behind a shuffle buffer (the reference's
    GCSTFRecordWriter without the upload; a local path). A buffer of
    fewer than 10 writes straight through. Once the buffer holds
    ``buffer_size`` records, each write shuffles it (Python's global
    ``random``, so ``random.seed`` fixes the order) and writes a fifth of
    it, then buffers the new record; ``close`` shuffles and writes the
    rest.

    ``faithful_drop=True`` reproduces the reference's quirk of losing the
    record that triggers a flush (about one record per flush); the default
    keeps every record."""

    def __init__(self, path: str, buffer_size: int = 1, faithful_drop: bool = False):
        self._w = TFRecordWriter(path)
        self.buffer_size = buffer_size
        self.faithful_drop = faithful_drop
        self.buffer: List[bytes] = []

    def write(self, payload: bytes) -> None:
        if self.buffer_size < 10:
            self._w.write(payload)
            return
        if len(self.buffer) < self.buffer_size:
            self.buffer.append(payload)
            return
        random.shuffle(self.buffer)
        for _ in range(self.buffer_size // 5):
            self._w.write(self.buffer.pop())
        if not self.faithful_drop:
            self.buffer.append(payload)

    def close(self) -> None:
        if self.buffer_size > 1:
            random.shuffle(self.buffer)
        for x in self.buffer:
            self._w.write(x)
        self._w.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


def chunk_features(chunk: Dict[str, Any], jpeg: bytes, width: int, height: int,
                   video_id: str, chunk_num: int) -> Dict[str, Any]:
    """One chunk's features in the pretraining schema (the keys a
    ``c{i:02d}/`` prefix takes in an example)."""
    return {
        "image/encoded": jpeg,
        "image/height": [height],
        "image/width": [width],
        "image/key/sha256": hashlib.sha256(jpeg).hexdigest().encode(),
        "image/format": b"jpeg",
        "youtube_id": video_id.encode(),
        "tokenized_cleaned_asr": list(chunk["clean_enc"]),
        "tokenized_raw_asr": list(chunk["noisy_enc"]),
        "is_eoc": [int(chunk["is_eoc"])],
        "mean_time": [float(chunk["mean_timestep"])],
        "chunk_num": [chunk_num],
    }


def video_chunk_iterator(video_item: Dict[str, Any], video_file: str,
                         tokenizer=None) -> Iterator[List[Dict[str, Any]]]:
    """One video's chunks, each with its frame (a PIL image at the stored
    size), 'chunk_num' and 'video_id'; nothing when a frame fails."""
    from PIL import Image

    from merlot_tpu_torch.data.video import extract_frames_from_video, get_size_for_resize
    chunks = split_video_into_chunks(video_item, tokenizer)
    frames = extract_frames_from_video(video_file, [c["mean_timestep"] for c in chunks])
    if frames is None:
        return
    trg = get_size_for_resize((frames.shape[2], frames.shape[1]),
                              shorter_size_trg=384, longer_size_max=512)
    for i, frame in enumerate(frames):
        img = Image.fromarray(np.ascontiguousarray(frame))   # uint8 [H, W, 3]: RGB
        if trg != img.size:
            img = img.resize(trg, resample=Image.BICUBIC)
        chunks[i]["chunk_num"] = i
        chunks[i]["frame"] = img
        chunks[i]["video_id"] = video_item["info"]["id"]
    yield chunks


def write_pretrain_shard(videos: Iterator, out_path: str, num_chunks: int = NUM_CHUNKS,
                         shuffle_buffer: int = 100,
                         stats: Optional[Dict[str, int]] = None) -> int:
    """Group the chunks of (video_item, video_file) pairs into examples of
    ``num_chunks`` (a video's tail joins the next video's head; what is
    left at the end is dropped) and write them through a shuffle buffer.
    Returns the examples written; ``stats``, when given, receives the
    videos and chunks read."""
    tokenizer = get_tokenizer()
    buffer: List[Dict[str, Any]] = []
    n_written = 0
    seen = {"videos": 0, "chunks": 0}
    with ShufflingTFRecordWriter(out_path, buffer_size=shuffle_buffer) as w:
        def flush():
            nonlocal n_written, buffer
            while len(buffer) >= num_chunks:
                group, buffer = buffer[:num_chunks], buffer[num_chunks:]
                feats = {}
                for i, c in enumerate(group):
                    buf = io.BytesIO()
                    c["frame"].save(buf, format="JPEG", quality=95)
                    for k, v in chunk_features(c, buf.getvalue(), c["frame"].width,
                                               c["frame"].height, c["video_id"],
                                               c["chunk_num"]).items():
                        feats[f"c{i:02d}/{k}"] = v
                w.write(encode_example(feats))
                n_written += 1

        for video_item, video_file in videos:
            seen["videos"] += 1
            for chunks in video_chunk_iterator(video_item, video_file, tokenizer):
                seen["chunks"] += len(chunks)
                buffer.extend(chunks)
                flush()
    if stats is not None:
        stats.update(seen)
    return n_written


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    """Run the CLI on ``argv`` (``sys.argv[1:]`` when None): the videos'
    chunks into one shard. Prints and returns the examples written, the
    videos and chunks read, the frame route and the seconds."""
    from merlot_tpu_torch.data.video import frame_route

    ap = argparse.ArgumentParser(description="videos and their .grover.json -> a pretrain shard")
    ap.add_argument("--videos", nargs="+", required=True,
                    help="video files; '<stem>.grover.json' must sit beside each")
    ap.add_argument("--out", default="out.tfrecord")
    ap.add_argument("--num_chunks", type=int, default=NUM_CHUNKS)
    ap.add_argument("--shuffle_buffer", type=int, default=100)
    args = ap.parse_args(sys.argv[1:] if argv is None else list(argv))

    def videos():
        for vf in args.videos:
            with open(vf.rsplit(".", 1)[0] + ".grover.json") as f:
                yield json.load(f), vf

    route = frame_route()
    stats: Dict[str, int] = {}
    t0 = time.perf_counter()
    n = write_pretrain_shard(videos(), args.out, num_chunks=args.num_chunks,
                             shuffle_buffer=args.shuffle_buffer, stats=stats)
    result = {"examples": n, **stats, "frame_route": route,
              "seconds": time.perf_counter() - t0, "out": args.out}
    print(f"wrote {n} examples to {args.out} ({stats['videos']} videos, "
          f"{stats['chunks']} chunks, frames by {route}, {result['seconds']:.2f} s)")
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
