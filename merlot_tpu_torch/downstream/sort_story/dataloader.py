"""sort_story loader: 5 images + 5 sentences per story (counterpart of
merlot_tpu/downstream/sort_story/dataloader.py).

No random scale and no augmentation: sentences are START-prefixed and
padded to 32 tokens, images ``resize_and_pad``'ed to the config's
image_size. For the same files, config and seed the batches are the JAX
loader's bit for bit where both decode JPEGs with libjpeg.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, List, Sequence

import numpy as np

from merlot_tpu_torch.core.tokenizer import PADDING, START
from merlot_tpu_torch.data import image_ops
from merlot_tpu_torch.data.pretrain_loader import shard_files, shuffle_records
from merlot_tpu_torch.data.tfrecord import parse_example, read_tfrecords

MAX_NUM_TOKENS = 32


def parse_story_example(payload: bytes, config: Dict[str, Any]
                        ) -> Dict[str, np.ndarray]:
    num_chunks = config["num_chunks"]
    image_size = config["image_size"]
    ex = parse_example(payload)

    images = np.zeros((num_chunks, image_size[0], image_size[1], 3), np.float32)
    sentences = np.full((num_chunks, MAX_NUM_TOKENS), PADDING, np.int32)
    for i in range(num_chunks):
        img = image_ops.decode_jpeg_u8(ex[f"image/image_{i}_encoded"][0])
        images[i], _ = image_ops.resize_and_pad(img, image_size)
        toks = np.asarray(ex[f"sentence/sentence_{i}"], np.int32)[:MAX_NUM_TOKENS - 1]
        sentences[i, 0] = START
        sentences[i, 1:1 + len(toks)] = toks

    return {
        "images": images,
        "sentences": sentences,
        "story_id": np.int64(ex["story_id"][0]),
        "permutation_identity_encode": np.int64(ex["permutation_identity_encode"][0]),
    }


def story_batches(files: Sequence[str], config: Dict[str, Any],
                  batch_size: int, is_training: bool = False,
                  seed: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    """Story batches, full ones only (eval shards are padded with replicas
    of their last story). Eval, the default, reads strictly in order so
    that permutation scoring sees a stable order; training shuffles the
    file order and passes the records through a shuffle buffer (config
    ``shuffle_buffer_size``, default 64)."""
    rng = np.random.default_rng(seed)
    sharded = shard_files(files, shuffle=is_training, seed=seed)
    buffer_size = config.get("shuffle_buffer_size", 64) if is_training else 0

    def records() -> Iterator[bytes]:
        for f in sharded:
            yield from read_tfrecords(f)

    buf: List[Dict[str, np.ndarray]] = []
    for rec in shuffle_records(records(), buffer_size, rng):
        buf.append(parse_story_example(rec, config))
        if len(buf) == batch_size:
            yield {k: np.stack([e[k] for e in buf]) for k in buf[0]}
            buf = []
