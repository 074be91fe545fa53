"""VCR loaders (counterpart of merlot_tpu/downstream/vcr/dataloader.py;
numpy on the host).

  * the joint train loader: per example the answer-mode AND the
    rationale-mode image, and all 4 choices of each; a sequence is
    ``[START prompt] ctx choice END`` padded to 184 tokens, the prompts
    ' answer question:' and ' provide rationale:'; a batch flattens to
    images [b*2, h, w, 3], lm_input [b*2*4, 184], lm_targets [b*2];
  * the eval loader: one mode; lm_input stays [b, 4, 184].

Images are the config's ``draw`` variant ('segm' or 'bbox'),
``resize_and_pad``'ed with a random scale in [0.9, 1.1] in training. For
the same files, config and seed the batches are the JAX loader's bit for
bit where both decode JPEGs with libjpeg. ``vcr_joint_batches(start=k)``
begins at the k-th batch of that stream without decoding the examples
before it (a resumed run's stream; the JAX package restarts it).
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, List, Optional, Sequence

import numpy as np

from merlot_tpu_torch.core.tokenizer import END, PADDING, START, get_tokenizer
from merlot_tpu_torch.data import image_ops
from merlot_tpu_torch.data.pretrain_loader import shard_files, shuffle_records
from merlot_tpu_torch.data.tfrecord import parse_example, read_tfrecords

MAX_NUM_TOKENS = 184
MODES = ("answer", "rationale")
SCALE_MIN, SCALE_MAX = 0.9, 1.1

_PROMPTS: Optional[Dict[str, List[int]]] = None


def vcr_prompts() -> Dict[str, List[int]]:
    global _PROMPTS
    if _PROMPTS is None:
        tok = get_tokenizer()
        _PROMPTS = {"answer": [START] + tok.encode(" answer question:"),
                    "rationale": [START] + tok.encode(" provide rationale:")}
    return _PROMPTS


def _sequence(prompt: List[int], ctx, choice) -> np.ndarray:
    seq = np.concatenate([np.asarray(prompt, np.int32), np.asarray(ctx, np.int32),
                          np.asarray(choice, np.int32), [END]])[:MAX_NUM_TOKENS]
    out = np.full(MAX_NUM_TOKENS, PADDING, np.int32)
    out[:len(seq)] = seq
    return out


def _decode_image(ex, mode: str, draw: str, image_size, rng, is_training):
    img = image_ops.decode_jpeg_u8(ex[f"{mode}/{draw}/image/encoded"][0])
    if is_training:
        img, _ = image_ops.resize_and_pad(img, image_size, rng=rng, do_random_scale=True,
                                          random_scale_min=SCALE_MIN,
                                          random_scale_max=SCALE_MAX)
    else:
        img, _ = image_ops.resize_and_pad(img, image_size)
    return img.astype(np.float32)


def _skip_draws(rng: np.random.Generator) -> None:
    """Draw from ``rng`` what ``parse_vcr_joint`` draws for one training
    example: per image, resize_and_pad's scale and its two crop offsets."""
    for _ in MODES:
        rng.uniform(SCALE_MIN, SCALE_MAX)
        rng.uniform(0, 1)
        rng.uniform(0, 1)


def parse_vcr_joint(payload: bytes, config: Dict[str, Any], rng: np.random.Generator,
                    is_training: bool = True) -> Dict[str, Any]:
    draw = config.get("draw", "segm")
    ex = parse_example(payload)
    prompts = vcr_prompts()
    images = np.stack([_decode_image(ex, m, draw, config["image_size"], rng, is_training)
                       for m in MODES])
    lm_input = np.stack([
        np.stack([_sequence(prompts[m], ex[f"{m}/ctx"], ex[f"{m}/choice_{i}"])
                  for i in range(4)])
        for m in MODES])                                          # [2, 4, 184]
    lm_targets = np.array([int(ex["label/answer_label"][0]),
                           int(ex["label/rationale_label"][0])], np.int32)
    return {"images": images, "lm_input": lm_input, "lm_targets": lm_targets,
            "annot_id": ex["annot_id"][0]}


def parse_vcr_single(payload: bytes, config: Dict[str, Any], mode: str) -> Dict[str, Any]:
    draw = config.get("draw", "segm")
    ex = parse_example(payload)
    prompts = vcr_prompts()
    image = _decode_image(ex, mode, draw, config["image_size"], None, False)
    lm_input = np.stack([_sequence(prompts[mode], ex[f"{mode}/ctx"],
                                   ex[f"{mode}/choice_{i}"]) for i in range(4)])
    return {"images": image, "lm_input": lm_input,
            "lm_targets": np.int32(ex[f"label/{mode}_label"][0]),
            "annot_id": ex["annot_id"][0]}


def vcr_joint_batches(files: Sequence[str], config: Dict[str, Any], batch_size: int,
                      is_training: bool = True, seed: int = 0,
                      repeat: Optional[bool] = None, start: int = 0
                      ) -> Iterator[Dict[str, np.ndarray]]:
    """Training batches, flattened like the reference's _process_example.

    In training the records pass through a shuffle buffer (config
    ``shuffle_buffer_size``, default 64) on top of a file order shuffled
    anew every epoch, so an epoch's examples come in another order each
    time. ``start``: the first batch to yield; the records of the batches
    before it are read and shuffled but not decoded, and the random
    scale's draws they would have taken are drawn all the same."""
    rng = np.random.default_rng(seed)
    files = shard_files(files, shuffle=is_training, seed=seed)
    repeat = is_training if repeat is None else repeat
    buffer_size = config.get("shuffle_buffer_size", 64) if is_training else 0
    h, w = config["image_size"]
    to_skip = start * batch_size

    def records() -> Iterator[bytes]:
        for f in files:
            yield from read_tfrecords(f)

    buf: List[Dict[str, Any]] = []
    while True:
        if is_training:          # a fresh file order every epoch, like
            rng.shuffle(files)   # tf.data's reshuffle_each_iteration
        for rec in shuffle_records(records(), buffer_size, rng):
            if to_skip:
                to_skip -= 1
                if is_training:
                    _skip_draws(rng)
                continue
            buf.append(parse_vcr_joint(rec, config, rng, is_training))
            if len(buf) < batch_size:
                continue
            b = {k: np.stack([e[k] for e in buf]) for k in ("images", "lm_input", "lm_targets")}
            buf = []
            yield {"images": b["images"].reshape(batch_size * 2, h, w, 3),
                   "lm_input": b["lm_input"].reshape(batch_size * 2 * 4, MAX_NUM_TOKENS),
                   "lm_targets": b["lm_targets"].reshape(batch_size * 2)}
        if not repeat:
            return


def vcr_eval_batches(files: Sequence[str], config: Dict[str, Any], batch_size: int,
                     mode: str = "answer") -> Iterator[Dict[str, Any]]:
    """Single-mode batches in file order, full ones only (a remainder is
    dropped, as the JAX loader drops it). ``annot_id`` is a list of bytes."""
    buf: List[Dict[str, Any]] = []
    for f in shard_files(files):
        for rec in read_tfrecords(f):
            buf.append(parse_vcr_single(rec, config, mode))
            if len(buf) == batch_size:
                yield {k: (np.stack([e[k] for e in buf]) if k != "annot_id"
                           else [e[k] for e in buf]) for k in buf[0]}
                buf = []
