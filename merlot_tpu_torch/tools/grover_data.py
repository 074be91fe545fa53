"""Grover LM data: tfrecord writers and numpy batch iterators for denoiser
training (counterpart of merlot_tpu/tools/grover_data.py).

LM examples hold fixed-length ``input_ids`` [seq_length + 1] and, for the
denoise bonus weighting, ``is_target`` [seq_length + 1]; classification
examples hold ``input_ids`` [seq_length], ``label_ids`` and
``is_real_example``. The writers produce the JAX package's bytes and the
iterators its batches; ``lm_batches(start=k)`` begins at the k-th batch
without parsing the records before it (a resumed run's stream).
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, List, Optional, Sequence

import numpy as np

from merlot_tpu_torch.data.pretrain_loader import shard_files
from merlot_tpu_torch.data.tfrecord import (TFRecordWriter, encode_example, parse_example,
                                            read_tfrecords)


def _padded(seq: Sequence[int], length: int, pad_id: int) -> np.ndarray:
    out = np.full(length, pad_id, np.int64)
    out[:min(len(seq), length)] = seq[:length]
    return out


def write_lm_shard(path: str, sequences: Sequence[Sequence[int]], seq_length: int,
                   pad_id: int = 0,
                   is_target: Optional[Sequence[Sequence[int]]] = None) -> int:
    """Write fixed-length LM examples ([seq_length + 1] ids, cut or padded
    with ``pad_id``; ``is_target`` the same, padded with 0). Returns the
    number written."""
    n = 0
    with TFRecordWriter(path) as w:
        for i, seq in enumerate(sequences):
            feats: Dict[str, Any] = {"input_ids": list(_padded(seq, seq_length + 1, pad_id))}
            if is_target is not None:
                feats["is_target"] = list(_padded(is_target[i], seq_length + 1, 0))
            w.write(encode_example(feats))
            n += 1
    return n


def write_classification_shard(path: str, sequences: Sequence[Sequence[int]],
                               labels: Sequence[int], seq_length: int,
                               pad_id: int = 0) -> int:
    """Classification examples: input_ids [seq_length], label_ids,
    is_real_example. Returns the number written."""
    n = 0
    with TFRecordWriter(path) as w:
        for seq, label in zip(sequences, labels):
            w.write(encode_example({"input_ids": list(_padded(seq, seq_length, pad_id)),
                                    "label_ids": [int(label)], "is_real_example": [1]}))
            n += 1
    return n


def _records(files: Sequence[str], repeat: bool, skip: int = 0) -> Iterator[bytes]:
    """Every record of ``files`` in order, over again while ``repeat``;
    the first ``skip`` are counted, not returned."""
    while True:
        for f in files:
            for rec in read_tfrecords(f):
                if skip:
                    skip -= 1
                    continue
                yield rec
        if not repeat:
            return


def _batched(items: Iterator[Dict[str, np.ndarray]], batch_size: int
             ) -> Iterator[Dict[str, np.ndarray]]:
    buf: List[Dict[str, np.ndarray]] = []
    for item in items:
        buf.append(item)
        if len(buf) == batch_size:
            yield {k: np.stack([e[k] for e in buf]) for k in buf[0]}
            buf = []


def classification_batches(files: Sequence[str], seq_length: int, batch_size: int,
                           is_training: bool = True, seed: int = 0,
                           repeat: Optional[bool] = None) -> Iterator[Dict[str, np.ndarray]]:
    """Batches of {'input_ids' [b, seq_length], 'label_ids' [b],
    'is_real_example' [b]} int32; the files shuffled from ``seed`` when
    training, repeated when training unless ``repeat`` says otherwise."""
    files = shard_files(files, shuffle=is_training, seed=seed)
    repeat = is_training if repeat is None else repeat

    def items():
        for rec in _records(files, repeat):
            ex = parse_example(rec)
            item = {"input_ids": np.asarray(ex["input_ids"], np.int32),
                    "label_ids": np.int32(ex["label_ids"][0]),
                    "is_real_example": np.int32(ex["is_real_example"][0])}
            if item["input_ids"].shape != (seq_length,):
                raise ValueError(f"input_ids of shape {item['input_ids'].shape}, "
                                 f"want ({seq_length},)")
            yield item
    return _batched(items(), batch_size)


def lm_batches(files: Sequence[str], seq_length: int, batch_size: int,
               is_training: bool = True, seed: int = 0, repeat: Optional[bool] = None,
               start: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    """Batches of {'input_ids', 'is_target'} int32 [b, seq_length + 1]
    (is_target zeros where the records have none); files and repeat as
    for ``classification_batches``. ``start``: begin at that batch of the
    stream, passing over the records before it unparsed."""
    files = shard_files(files, shuffle=is_training, seed=seed)
    repeat = is_training if repeat is None else repeat

    def items():
        for rec in _records(files, repeat, skip=start * batch_size):
            ex = parse_example(rec)
            ids = np.asarray(ex["input_ids"], np.int32)
            if ids.shape != (seq_length + 1,):
                raise ValueError(f"input_ids of shape {ids.shape}, want ({seq_length + 1},)")
            yield {"input_ids": ids,
                   "is_target": (np.asarray(ex["is_target"], np.int32) if "is_target" in ex
                                 else np.zeros_like(ids))}
    return _batched(items(), batch_size)
