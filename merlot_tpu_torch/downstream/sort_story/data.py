"""sort_story (VIST/SIND) tfrecord preparation (counterpart of
merlot_tpu/downstream/sort_story/data.py).

    python -m merlot_tpu_torch.downstream.sort_story.data \
        --story_json SIS.json --image_dir IMAGES --out val.tfrecord \
        [--fold F --num_folds N] [--just_one_perm] [--pad_to_batch_size B]

Each story is 5 images and 5 sentences. For evaluation every one of the
5! = 120 orderings of a story is one Example (or only the identity, with
``--just_one_perm``), the ordering encoded as ``int(''.join(perm)) +
900000``. Keys: ``permutation_identity_encode``, ``story_id``,
``sentence/sentence_{i}`` (int64 token ids) and
``image/image_{i}_encoded`` / ``_format`` / ``_sha256`` / ``_is_valid``.

Given the same inputs, ``story_example`` and ``write_story_tfrecords`` write
the JAX package's bytes. PIL is imported only inside
``write_story_tfrecords`` (the thumbnail and the JPEG re-encode).
``write_synthetic_story_shard`` draws what the JAX writer draws and encodes
its frames by this machine's JPEG route (``data/_native``): its bytes are
the JAX writer's where that route is libjpeg.
"""

from __future__ import annotations

import collections
import hashlib
import io
import itertools
import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from merlot_tpu_torch.core.tokenizer import get_tokenizer
from merlot_tpu_torch.data import _native
from merlot_tpu_torch.data.tfrecord import TFRecordWriter, encode_example


def _to_jpeg(image) -> bytes:
    if image.mode == "RGBA":
        image = image.convert("RGB")
    with io.BytesIO() as out:
        image.save(out, format="JPEG", quality=95)
        return out.getvalue()


def load_stories(story_json_path: str) -> Dict[int, List[dict]]:
    """story_id -> its 5 annotations sorted by the worker's photo order."""
    with open(story_json_path) as f:
        data = json.load(f)
    by_story = collections.defaultdict(list)
    for ann in data["annotations"]:
        ann = ann[0]
        by_story[int(ann["story_id"])].append(ann)
    out = {}
    for sid, anns in by_story.items():
        if len(anns) != 5:
            raise ValueError(f"story {sid} has {len(anns)} annotations, not 5")
        out[sid] = sorted(anns, key=lambda a: a["worker_arranged_photo_order"])
    return out


def story_example(story_id: int, texts: Sequence[Sequence[int]],
                  jpegs: Sequence[bytes], perm: Sequence[int]) -> bytes:
    """One (story, permutation) Example, serialized, in the reference schema."""
    perm_encode = int("".join(str(x) for x in perm)) + 900000
    feats = {"permutation_identity_encode": [perm_encode],
             "story_id": [int(story_id)]}
    for out_idx, src_idx in enumerate(perm):
        feats[f"sentence/sentence_{out_idx}"] = list(texts[src_idx])
        feats[f"image/image_{out_idx}_encoded"] = jpegs[src_idx]
        feats[f"image/image_{out_idx}_format"] = b"jpeg"
        feats[f"image/image_{out_idx}_sha256"] = hashlib.sha256(
            jpegs[src_idx]).hexdigest().encode()
        feats[f"image/image_{out_idx}_is_valid"] = [1]
    return encode_example(feats)


def write_story_tfrecords(story_json_path: str, image_directory: str,
                          out_path: str, just_one_perm: bool = False,
                          fold: int = 0, num_folds: int = 1,
                          pad_to_batch_size: Optional[int] = None) -> int:
    """Write the (story x permutation) Examples of one fold; returns their
    count. With ``pad_to_batch_size`` the shard ends with replicas of its
    last Example up to a multiple of it (evaluation reads full batches)."""
    from PIL import Image
    tok = get_tokenizer()
    stories = load_stories(story_json_path)
    paths = {p.split(".")[0]: os.path.join(image_directory, p)
             for p in os.listdir(image_directory)}

    n = 0
    last = None
    with TFRecordWriter(out_path) as w:
        for idx, sid in enumerate(sorted(stories.keys())):
            if idx % num_folds != fold:
                continue
            anns = stories[sid]
            texts = [tok.encode(a["original_text"]) for a in anns]
            jpegs = []
            for a in anns:
                img = Image.open(paths[a["photo_flickr_id"]])
                img.thumbnail((800, 800))
                jpegs.append(_to_jpeg(img))
            perms = [range(5)] if just_one_perm else itertools.permutations(range(5))
            for perm in perms:
                last = story_example(sid, texts, jpegs, list(perm))
                w.write(last)
                n += 1
        if pad_to_batch_size and last is not None:
            for _ in range((-n) % pad_to_batch_size):
                w.write(last)
                n += 1
    return n


def write_synthetic_story_shard(path: str, num_stories: int = 2,
                                just_one_perm: bool = True, seed: int = 0,
                                img_hw=(64, 80),
                                pad_to_batch_size: Optional[int] = None) -> int:
    """Synthetic stories in the same schema: random sentences and frames of
    uniform noise (JPEG quality 80). Returns the number of Examples
    written; with ``pad_to_batch_size`` the shard is padded as
    ``write_story_tfrecords`` pads it."""
    rng = np.random.default_rng(seed)
    n = 0
    last = None
    with TFRecordWriter(path) as w:
        for sid in range(num_stories):
            texts = [list(rng.integers(100, 50357, int(rng.integers(4, 20))))
                     for _ in range(5)]
            jpegs = [_native.encode_jpeg(rng.integers(0, 256, (*img_hw, 3), dtype=np.uint8),
                                         quality=80) for _ in range(5)]
            perms = [range(5)] if just_one_perm else itertools.permutations(range(5))
            for perm in perms:
                last = story_example(sid, texts, jpegs, list(perm))
                w.write(last)
                n += 1
        if pad_to_batch_size and last is not None:
            for _ in range((-n) % pad_to_batch_size):
                w.write(last)
                n += 1
    return n


def main(argv=None):
    """VIST SIS json + image dir -> permutation tfrecords, one fold per
    process."""
    import argparse
    ap = argparse.ArgumentParser(description=main.__doc__)
    ap.add_argument("--story_json", required=True)
    ap.add_argument("--image_dir", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--fold", type=int, default=0)
    ap.add_argument("--num_folds", type=int, default=1)
    ap.add_argument("--just_one_perm", action="store_true")
    ap.add_argument("--pad_to_batch_size", type=int, default=None)
    args = ap.parse_args(argv)
    n = write_story_tfrecords(args.story_json, args.image_dir, args.out,
                              just_one_perm=args.just_one_perm,
                              fold=args.fold, num_folds=args.num_folds,
                              pad_to_batch_size=args.pad_to_batch_size)
    print(f"wrote {n} examples to {args.out}")


if __name__ == "__main__":
    main()
