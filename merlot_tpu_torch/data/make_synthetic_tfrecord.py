"""Generate synthetic pretrain tfrecords in the reference schema
(counterpart of merlot_tpu/data/make_synthetic_tfrecord.py).

    python -m merlot_tpu_torch.data.make_synthetic_tfrecord --out_dir D

Produces shards whose per-chunk feature keys match the reference writer
(data/process.py:234-263): ``c{i:02d}/image/encoded``,
``tokenized_cleaned_asr``, ``tokenized_raw_asr``, ``is_eoc``, ``mean_time``,
``chunk_num``, ``youtube_id``, etc. Frames are smooth low-frequency noise
(a coarse random grid resized up, plus grain), so a JPEG has about the size
of a real frame's; they are encoded by the machine's JPEG route
(``data/_native``: libjpeg, else nvJPEG on the card).
"""

from __future__ import annotations

import argparse
import os
from typing import Optional

import numpy as np

from merlot_tpu_torch.data import _native
from merlot_tpu_torch.data.image_ops import resize_bilinear_ac
from merlot_tpu_torch.data.tfrecord import TFRecordWriter, encode_example

GRID = 32      # pixels per cell of the coarse random grid
GRAIN = 6.0    # std of the per-pixel noise, in levels


def smooth_frame(rng: np.random.Generator, h: int, w: int) -> np.ndarray:
    """uint8 RGB [h, w, 3]: a coarse random grid resized up, plus grain."""
    coarse = rng.uniform(0, 255, (max(2, h // GRID), max(2, w // GRID), 3))
    img = resize_bilinear_ac(coarse.astype(np.float32), h, w)
    img += rng.normal(0.0, GRAIN, img.shape).astype(np.float32)
    return np.clip(np.rint(img), 0, 255).astype(np.uint8)


def _random_jpeg(rng: np.random.Generator, h: int, w: int) -> bytes:
    return _native.encode_jpeg(smooth_frame(rng, h, w), quality=80)


def write_synthetic_shard(path: str, num_examples: int = 4,
                          num_chunks: int = 16, seed: int = 0,
                          img_hw=(96, 160), max_tokens: int = 28) -> None:
    rng = np.random.default_rng(seed)
    with TFRecordWriter(path) as w:
        for ex_i in range(num_examples):
            features = {}
            # segments come in video blocks of random length, like real data
            boundaries = set()
            pos = 0
            while pos < num_chunks - 1:
                pos += int(rng.integers(2, 6))
                if pos < num_chunks:
                    boundaries.add(pos - 1)
            for i in range(num_chunks):
                pre = f"c{i:02d}/"
                n_tok = int(rng.integers(4, max_tokens))
                features[pre + "image/encoded"] = _random_jpeg(rng, *img_hw)
                features[pre + "image/format"] = b"jpeg"
                features[pre + "image/key/sha256"] = b""
                features[pre + "image/height"] = [img_hw[0]]
                features[pre + "image/width"] = [img_hw[1]]
                features[pre + "youtube_id"] = f"synthvid{ex_i:05d}".encode()
                features[pre + "tokenized_cleaned_asr"] = list(
                    rng.integers(100, 50357, n_tok))
                features[pre + "tokenized_raw_asr"] = list(
                    rng.integers(100, 50357, n_tok))
                features[pre + "is_eoc"] = [1 if i in boundaries else 0]
                features[pre + "mean_time"] = [float(i) * 5.0]
                features[pre + "chunk_num"] = [i]
            w.write(encode_example(features))


def main(argv: Optional[list] = None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out_dir", required=True)
    ap.add_argument("--num_shards", type=int, default=2)
    ap.add_argument("--num_examples", type=int, default=4)
    ap.add_argument("--num_chunks", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    os.makedirs(args.out_dir, exist_ok=True)
    for s in range(args.num_shards):
        path = os.path.join(args.out_dir,
                            f"train-{s:05d}-of-{args.num_shards:05d}.tfrecord")
        write_synthetic_shard(path, args.num_examples, args.num_chunks,
                              seed=args.seed + s)
        print("wrote", path)


if __name__ == "__main__":
    main()
