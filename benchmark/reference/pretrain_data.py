"""The pretraining batches read from tfrecord shards in plain numpy, PIL and
torch: what the reference steps of ``traffic/pretrain_cli.py`` are fed.

Written from the data path's specification, not from the port's code:
the TFRecord framing and the tf.train.Example wire format are read here,
the JPEGs decoded with PIL, the images resized with torch's
``F.interpolate``. The loader's random choices are drawn again from the
same seeds in the same order, which is the part of its design the two
sides share:

  * the files' order: ``default_rng(seed).shuffle`` of the sorted paths;
  * the records: one from each file in turn (every file in the cycle, at
    most ``cycle_length``), the files read again from the start when all
    are done, through a reservoir of ``shuffle_buffer`` records: when it
    is full each record taken out is the one at ``integers(0, size)`` of
    the stream's generator ``default_rng(seed)``, swapped with the last
    and popped;
  * each record's own generator: ``default_rng`` of the ``SeedSequence``
    of ``seed + 1`` with spawn key (k,) for the k-th record taken out.
    It draws whether the clean or the raw transcript is read (uniform <
    ``clean_asr_prob``), then per frame the scale ``uniform(min, max)``,
    the crop's two uniforms, the resize method (``integers(0, 4)`` over
    bilinear, nearest, bicubic, area, all with aligned corners but area)
    and the augmentation (uniform < ``augment_prob``, then brightness or
    contrast by ``integers(0, 2)`` and three factors ``uniform(1 - 0.32,
    1 + 0.32)``);
  * after each batch's records, the stream's generator draws the blocks'
    new order (``uniform`` [B, n] argsorted, with ``shuffle_chunks``) and
    the frame shuffle: ``choice`` of how many frames of a group move, then
    two ``uniform`` [groups, g] argsorted (which move and where to).

Token ids 2 and 5 are the tokenizer's START and NEXTCAPTION_START.
"""

from __future__ import annotations

import io
import struct
from typing import Any, Dict, Iterator, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

START, NEXTCAPTION_START = 2, 5
RESIZE_METHODS = ("bilinear", "nearest", "bicubic", "area")
AUGMENT_DELTA = 0.8 * 0.4      # the augmentation's strength 0.4


# ----------------------------------------------------------------------
# the shards
# ----------------------------------------------------------------------
def read_records(path: str) -> List[bytes]:
    """The payloads of a TFRecord file: u64 length, u32 crc, payload, u32 crc."""
    with open(path, "rb") as f:
        raw = f.read()
    out, pos = [], 0
    while pos < len(raw):
        (n,) = struct.unpack_from("<Q", raw, pos)
        out.append(raw[pos + 12:pos + 12 + n])
        pos += 16 + n
    return out


def _varint(buf: bytes, pos: int):
    v = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        v |= (b & 0x7F) << shift
        shift += 7
        if b < 0x80:
            return v, pos


def _fields(buf: bytes) -> Iterator[tuple]:
    """(field, wire type, value) of a message: ints for varints, bytes for
    length-delimited fields, 4 bytes for fixed32."""
    pos = 0
    while pos < len(buf):
        tag, pos = _varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 0:
            v, pos = _varint(buf, pos)
        elif wire == 2:
            n, pos = _varint(buf, pos)
            v, pos = buf[pos:pos + n], pos + n
        elif wire == 5:
            v, pos = buf[pos:pos + 4], pos + 4
        elif wire == 1:
            v, pos = buf[pos:pos + 8], pos + 8
        else:
            raise ValueError(f"wire type {wire}")
        yield field, wire, v


def example_features(payload: bytes) -> Dict[str, list]:
    """tf.train.Example -> {key: [bytes] | [float] | [int]}."""
    out = {}
    for f, _, features in _fields(payload):
        if f != 1:
            continue
        for f2, _, entry in _fields(features):
            if f2 != 1:
                continue
            key, value = None, []
            for f3, _, v in _fields(entry):
                if f3 == 1:
                    key = v.decode()
                elif f3 == 2:
                    for kind, _, lst in _fields(v):
                        for f4, wire, item in _fields(lst):
                            if f4 != 1:
                                continue
                            if kind == 1:
                                value.append(item)
                            elif kind == 2:
                                value.extend(np.frombuffer(item, "<f4").tolist()
                                             if wire == 2 else struct.unpack("<f", item))
                            elif wire == 2:          # packed int64
                                p = 0
                                while p < len(item):
                                    x, p = _varint(item, p)
                                    value.append(x - (1 << 64) if x >> 63 else x)
                            else:
                                value.append(item - (1 << 64) if item >> 63 else item)
            out[key] = value
    return out


# ----------------------------------------------------------------------
# one frame
# ----------------------------------------------------------------------
def decode(data: bytes) -> np.ndarray:
    from PIL import Image
    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im.convert("RGB"))


def _aligned_nearest(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    def index(out, size):
        if out == 1:
            return torch.zeros(1, dtype=torch.long)
        return torch.from_numpy(np.rint(np.arange(out) * ((size - 1) / (out - 1)))
                                .astype(np.int64).clip(0, size - 1))
    return x[:, :, index(h, x.shape[2])][:, :, :, index(w, x.shape[3])]


def resize(img: np.ndarray, h: int, w: int, method: str) -> np.ndarray:
    """uint8 [H, W, 3] -> float32 [h, w, 3] in [0, 1]."""
    x = torch.from_numpy(img.astype(np.float32) / 255.0).permute(2, 0, 1)[None]
    if method == "nearest":
        y = _aligned_nearest(x, h, w)
    elif method == "area":
        y = F.interpolate(x, size=(h, w), mode="area")
    else:
        y = F.interpolate(x, size=(h, w), mode=method, align_corners=True)
    return y[0].permute(1, 2, 0).numpy()


def frame(img: np.ndarray, size: Sequence[int], rng: np.random.Generator,
          cfg: Dict[str, Any]) -> np.ndarray:
    """A frame scaled by a random factor of the output size (the short side
    at least 64 pixels), cropped at a random offset, padded with 0, then
    perhaps brightened or contrasted."""
    dh, dw = int(size[0]), int(size[1])
    h, w = float(img.shape[0]), float(img.shape[1])
    f = rng.uniform(cfg.get("random_scale_min", 0.95), cfg.get("random_scale_max", 1.05))
    scale = min(int(np.float32(f * dw)) / w, int(np.float32(f * dh)) / h)
    scale = max(scale, 64.0 / min(h, w))
    sh, sw = int(np.float32(h * scale)), int(np.float32(w * scale))
    oy = int(np.float32(max(0.0, float(sh - dh)) * rng.uniform(0, 1)))
    ox = int(np.float32(max(0.0, float(sw - dw)) * rng.uniform(0, 1)))
    method = RESIZE_METHODS[int(rng.integers(0, len(RESIZE_METHODS)))]
    crop = resize(img, sh, sw, method)[oy:oy + dh, ox:ox + dw]
    out = np.zeros((dh, dw, 3), np.float32)
    out[:crop.shape[0], :crop.shape[1]] = crop
    out = np.where(np.isfinite(out), out, 0.0).astype(np.float32)
    p = cfg.get("augment_prob", 0.0)
    if p > 0.0 and rng.uniform() < p:
        contrast = int(rng.integers(0, 2)) == 1
        factor = rng.uniform(1.0 - AUGMENT_DELTA, 1.0 + AUGMENT_DELTA, (1, 1, 3)).astype(np.float32)
        if contrast:
            mean = out.reshape(-1, 3).mean(0).reshape(1, 1, 3)
            out = (out - mean) * factor + mean
        else:
            out = out * factor
        out = np.clip(out, 0.0, 1.0).astype(np.float32)
    return out


# ----------------------------------------------------------------------
# one example, one batch
# ----------------------------------------------------------------------
def example(payload: bytes, cfg: Dict[str, Any], rng: np.random.Generator) -> Dict[str, np.ndarray]:
    ex = example_features(payload)
    n, length = cfg["num_chunks"], cfg.get("chunk_text_len", 32)
    clean = rng.uniform() < cfg.get("clean_asr_prob", 0.5)
    key = "tokenized_cleaned_asr" if clean else "tokenized_raw_asr"
    images, ids = [], np.zeros((n, length), np.int64)
    eoc = np.zeros(n, bool)
    for i in range(n):
        pre = f"c{i:02d}/"
        images.append(frame(decode(ex[pre + "image/encoded"][0]), cfg["image_size"], rng, cfg))
        toks = ex[pre + key][:length - 1]
        ids[i, 0] = START if clean else NEXTCAPTION_START
        ids[i, 1:1 + len(toks)] = toks
        eoc[i] = bool(ex[pre + "is_eoc"][0]) or i == n - 1
    video = np.cumsum(np.concatenate([[0], eoc[:-1].astype(np.int64)]))
    return {"images": np.stack(images), "input_ids": ids, "video_src_ids": video}


def collate(examples: List[Dict[str, np.ndarray]], cfg: Dict[str, Any],
            rng: np.random.Generator) -> Dict[str, np.ndarray]:
    batch = {k: np.stack([e[k] for e in examples]) for k in examples[0]}
    b, n = batch["video_src_ids"].shape
    if cfg.get("shuffle_chunks", False):
        # each example's video blocks in a new order, frames kept in order inside
        order = np.argsort(rng.uniform(size=(b, n)), axis=-1)
        block = np.take_along_axis(order, batch["video_src_ids"], axis=1)
        idx = np.argsort(block * n + np.arange(n)[None], axis=1)
        rows = np.arange(b)[:, None]
        batch = {k: v[rows, idx] for k, v in batch.items()}
    g = cfg["num_chunks_in_group"]
    groups = b * n // g
    p = cfg.get("image_shuffle_prob", 0.5)
    if p < 1e-6:
        shuffled = np.tile(np.arange(g), groups)
    else:
        probs = np.array([1.0 - p, 1e-6] + [p / (g - 1)] * (g - 1))
        moves = rng.choice(len(probs), size=groups, p=probs / probs.sum())
        which = np.argsort(rng.uniform(size=(groups, g)), 1) < moves[:, None]
        to = cfg.get("shuffle_offset", 16) + np.argsort(rng.uniform(size=(groups, g)), 1)
        shuffled = np.where(which, to, np.arange(g)[None]).reshape(-1)
    h, w = batch["images"].shape[2:4]
    return {"images": batch["images"].reshape(b * n, h, w, 3), "input_ids": batch["input_ids"],
            "video_src_ids": batch["video_src_ids"], "shuffled_idx_img": shuffled}


def batches(files: Sequence[str], cfg: Dict[str, Any], batch_size: int, count: int, *,
            seed: int = 0, shuffle_buffer: int = 256, cycle_length: int = 16
            ) -> List[Dict[str, np.ndarray]]:
    """The first ``count`` training batches of ``batch_size`` examples from
    the shards ``files`` (``cfg``: the data keys and the model's image
    size, group and frame-shuffle keys), with the loader's ``seed``."""
    files = sorted(files)
    np.random.default_rng(seed).shuffle(files)
    if len(files) > cycle_length:
        raise ValueError(f"{len(files)} files: at most the cycle's {cycle_length} here")
    shards = [read_records(f) for f in files]

    def stream():
        while True:
            for i in range(max(len(s) for s in shards)):
                for s in shards:
                    if i < len(s):
                        yield s[i]

    rng = np.random.default_rng(seed)
    src, buf, out, taken = stream(), [], [], 0
    while len(out) < count:
        examples = []
        while len(examples) < batch_size:
            while len(buf) < max(1, shuffle_buffer):
                buf.append(next(src))
            if shuffle_buffer > 0:
                j = int(rng.integers(0, len(buf)))
                buf[j], buf[-1] = buf[-1], buf[j]
            rec = buf.pop() if shuffle_buffer > 0 else buf.pop(0)
            own = np.random.default_rng(np.random.SeedSequence(seed + 1, spawn_key=(taken,)))
            examples.append(example(rec, cfg, own))
            taken += 1
        out.append(collate(examples, cfg, rng))
    return out
