"""Async host data pipeline for pretraining (counterpart of
merlot_tpu/data/pretrain_loader.py).

Replaces the reference's tf.data input_fn (model/dataloader.py:129-280) with
a thread-pooled numpy pipeline feeding device-resident batches:

  files -> per-host shard -> round-robin interleave -> shuffle buffer
        -> parse (JPEG decode, random-scale align-corners resize+pad,
           brightness/contrast augment, NaN scrub, clean-vs-raw ASR choice,
           START/NEXTCAPTION_START prefix, pad to [num_chunks, 32])
        -> batch -> chunk-shuffle + frame-shuffle sampling -> prefetch queue

Behavioural parity notes (all from model/dataloader.py):
  * clean vs raw ASR is chosen **per example** w.p. ``clean_asr_prob``, with
    distinct start tokens START / NEXTCAPTION_START (:101-118);
  * ``is_eoc`` of the last chunk is forced to 1 and ``video_src_ids`` is the
    cumulative sum of end-of-clip deltas (:123-125);
  * chunk-shuffle re-randomizes *video block* order within an example
    (:211-222); frame-shuffle draws how many segments per group to shuffle
    from [1-p, ~0, p/(g-1)...] then offsets shuffled PE indices by
    ``shuffle_offset`` (:225-257). The reference uses offset 16 at pretrain
    (and 64 at zero-shot); note that 16 < 64 means shuffled frames still
    count "easy" in the temporal loss — we reproduce that quirk and expose
    ``shuffle_offset`` to change it;
  * images are NOT transposed — the reference's [H,W,3,B] ``transpose_input``
    (:259-264) is a TF1-TPU layout hack XLA does not need.

For the same files, config and seed, ``PretrainLoader`` yields the JAX
loader's batches bit for bit where both decode JPEGs with libjpeg (the
same per-record ``SeedSequence.spawn`` and collate ``rng``).
``batches(start)`` begins at a later batch without reading or parsing the
records of the batches before it (a resumed run's data stream).
``device_iterator`` replaces ``device_put_iterator``: pinned host buffers
copied to the card on a side CUDA stream while the step runs.
"""

from __future__ import annotations

import itertools
import queue
import threading
import warnings
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from merlot_tpu_torch.core.tokenizer import NEXTCAPTION_START, START
from merlot_tpu_torch.data import image_ops
from merlot_tpu_torch.data.tfrecord import _open, parse_example, record_spans

CHUNK_KEYS = ("image/encoded", "tokenized_cleaned_asr", "tokenized_raw_asr",
              "is_eoc", "mean_time", "chunk_num", "youtube_id")


def shard_files(files: Sequence[str], host_id: int = 0, num_hosts: int = 1,
                shuffle: bool = False, seed: Optional[int] = None) -> List[str]:
    """Per-host file sharding (reference: model/dataloader.py:146-167)."""
    files = list(files)
    if num_hosts > 1:
        assert len(files) // num_hosts >= 1
        files = files[host_id::num_hosts]
    elif shuffle:
        np.random.default_rng(seed).shuffle(files)
    return files


def shuffle_records(stream: Iterator[Any], buffer_size: int,
                    rng: np.random.Generator,
                    buf: Optional[List[Any]] = None) -> Iterator[Any]:
    """Record-level reservoir shuffle buffer (tf.data ``dataset.shuffle``
    semantics, reference: model/dataloader.py:180-184 and
    downstream/vcr/dataloader_joint.py:249-251): hold ``buffer_size``
    records, emit a uniformly chosen one as each new record arrives, flush
    shuffled at end-of-stream. ``buffer_size`` <= 0 passes through.

    ``buf`` is the buffer's list when the caller needs to reach it
    (``PretrainLoader.batches`` swaps the record positions it holds for the
    records); it holds exactly the records not yet emitted."""
    if buffer_size <= 0:
        yield from stream
        return
    buf = [] if buf is None else buf
    for rec in stream:
        buf.append(rec)
        if len(buf) >= buffer_size:
            j = rng.integers(0, len(buf))
            buf[j], buf[-1] = buf[-1], buf[j]
            yield buf.pop()
    rng.shuffle(buf)
    buf.reverse()
    while buf:
        yield buf.pop()


def parse_pretrain_example(payload: bytes, config: Dict[str, Any],
                           rng: np.random.Generator,
                           is_training: bool = True) -> Dict[str, np.ndarray]:
    """One serialized Example -> features dict (reference: :56-126)."""
    num_chunks = config["num_chunks"]
    image_size = config["image_size"]
    len_per_chunk = config.get("chunk_text_len", 32)

    ex = parse_example(payload)

    imgs = np.zeros((num_chunks, image_size[0], image_size[1], 3), np.float32)
    tokens = np.zeros((num_chunks, len_per_chunk), np.int32)
    is_eoc = np.zeros(num_chunks, bool)
    mean_time = np.zeros(num_chunks, np.float32)
    chunk_num = np.zeros(num_chunks, np.int32)

    do_clean = rng.uniform() < config.get("clean_asr_prob", 0.5)
    start_token = START if do_clean else NEXTCAPTION_START
    asr_key = "tokenized_cleaned_asr" if do_clean else "tokenized_raw_asr"

    for i in range(num_chunks):
        pre = f"c{i:02d}/"
        img = image_ops.decode_jpeg_u8(ex[pre + "image/encoded"][0])
        if is_training:
            img, _ = image_ops.resize_and_pad(
                img, image_size, rng=rng, do_random_scale=True,
                random_scale_max=config.get("random_scale_max", 1.05),
                random_scale_min=config.get("random_scale_min", 0.95),
                resize_method="random")
        else:
            img, _ = image_ops.resize_and_pad(img, image_size)
        img = np.where(np.isfinite(img), img, 0.0).astype(np.float32)
        if is_training and config.get("augment_prob", 0.0) > 0.0:
            img = image_ops.lightweight_image_augment(
                img, rng, augment_prob=config["augment_prob"],
                allowed_transforms="brightness,contrast")
        imgs[i] = img

        toks = np.asarray(ex[pre + asr_key], np.int32)[:len_per_chunk - 1]
        tokens[i, 0] = start_token
        tokens[i, 1:1 + len(toks)] = toks

        is_eoc[i] = bool(ex[pre + "is_eoc"][0]) if i < num_chunks - 1 else True
        mean_time[i] = float(ex[pre + "mean_time"][0])
        chunk_num[i] = int(ex[pre + "chunk_num"][0])

    # youtube id as a fixed-size uint8 array (encode_string analogue,
    # reference: utils/model_utils.py:628-637 + dataloader.py:66)
    yid = ex["c00/youtube_id"][0][:64] if "c00/youtube_id" in ex else b""
    youtube_id = np.zeros(64, np.uint8)
    youtube_id[:len(yid)] = np.frombuffer(yid, np.uint8)

    delta = np.concatenate([[0], is_eoc[:-1].astype(np.int32)])
    out = {
        "images": imgs,
        "input_ids": tokens,
        "is_eoc": is_eoc,
        "video_src_ids": np.cumsum(delta).astype(np.int32),
        "mean_time": mean_time,
        "chunk_num": chunk_num,
        "youtube_id": np.broadcast_to(youtube_id, (num_chunks, 64)).copy(),
    }
    # unbatch path for huge per-example chunk counts (reference:
    # model/dataloader.py:190-207): split one num_chunks example into
    # unbatch_size sub-examples of num_chunks/unbatch_size chunks each
    unbatch = config.get("unbatch_size", 1)
    if unbatch > 1:
        assert num_chunks % unbatch == 0
        sub = num_chunks // unbatch
        return [
            {k: v[i * sub:(i + 1) * sub] for k, v in out.items()}
            for i in range(unbatch)
        ]
    return out


# ----------------------------------------------------------------------
# batch-level transforms (reference: model/dataloader.py:210-276)
# ----------------------------------------------------------------------
def shuffle_chunks(batch: Dict[str, np.ndarray],
                   rng: np.random.Generator) -> Dict[str, np.ndarray]:
    """Re-randomize the order of video blocks inside each example."""
    vsrc = batch["video_src_ids"]
    bsz, nchunk = vsrc.shape
    mapping = np.argsort(rng.uniform(size=(bsz, nchunk)), axis=-1)
    new_chunkid = np.take_along_axis(mapping, vsrc, axis=1)
    trg_idx = new_chunkid * nchunk + np.arange(nchunk, dtype=np.int32)[None]
    idx = np.argsort(trg_idx, axis=1)
    out = dict(batch)
    # fancy row indexing, NOT np.take_along_axis: take_along_axis broadcasts
    # the index to the operand's FULL shape (for [B,16,192,352,3] images
    # that is a 26M-element int64 index + scalar gather — profiled at
    # ~1.1 s/batch, the whole loader's budget); advanced indexing gathers
    # whole chunk rows via memcpy. Semantics identical.
    rows = np.arange(bsz)[:, None]
    for k in ("images", "input_ids", "is_eoc", "video_src_ids", "mean_time",
              "chunk_num", "youtube_id"):
        if k in out:
            out[k] = out[k][rows, idx]
    return out


def sample_shuffled_idx(batch_size: int, num_chunks: int, group: int,
                        shuffle_prob: float, shuffle_offset: int,
                        rng: np.random.Generator) -> np.ndarray:
    """Frame-shuffle PE indices, flat [batch*num_chunks]
    (reference: :225-257)."""
    B = batch_size * num_chunks // group
    if shuffle_prob < 1e-6:
        return np.tile(np.arange(group, dtype=np.int32), B)

    probs = np.array([1.0 - shuffle_prob, 1e-6]
                     + [shuffle_prob / (group - 1)] * (group - 1))
    probs = probs / probs.sum()
    num_shuffle = rng.choice(len(probs), size=B, p=probs).astype(np.int32)
    do_shuffle = np.argsort(rng.uniform(size=(B, group)), 1) < num_shuffle[:, None]
    shuffled = np.where(
        do_shuffle,
        shuffle_offset + np.argsort(rng.uniform(size=(B, group)), 1),
        np.tile(np.arange(group, dtype=np.int64)[None], (B, 1)))
    return shuffled.reshape(-1).astype(np.int32)


def collate_pretrain_batch(examples: List[Dict[str, np.ndarray]],
                           config: Dict[str, Any],
                           rng: np.random.Generator,
                           is_training: bool = True) -> Dict[str, np.ndarray]:
    batch = {k: np.stack([e[k] for e in examples]) for k in examples[0]}
    if is_training and config.get("shuffle_chunks", False):
        batch = shuffle_chunks(batch, rng)

    bsz, nchunk = batch["input_ids"].shape[:2]
    group = config["num_chunks_in_group"]
    batch["shuffled_idx_img"] = sample_shuffled_idx(
        bsz, nchunk, group,
        shuffle_prob=config.get("image_shuffle_prob", 0.5),
        shuffle_offset=config.get("shuffle_offset", 16),
        rng=rng)

    # flatten frames: [bsz, nchunk, h, w, 3] -> [bsz*nchunk, h, w, 3]
    b, n, h, w, c = batch["images"].shape
    batch["images"] = batch["images"].reshape(b * n, h, w, c)
    return batch


def skip_collate(batch_size: int, config: Dict[str, Any], rng: np.random.Generator,
                 is_training: bool = True) -> None:
    """Advance ``rng`` as ``collate_pretrain_batch`` advances it for a batch
    of ``batch_size`` examples, without the examples."""
    nchunk = config["num_chunks"] // config.get("unbatch_size", 1)
    if is_training and config.get("shuffle_chunks", False):
        rng.uniform(size=(batch_size, nchunk))  # shuffle_chunks' draw
    sample_shuffled_idx(batch_size, nchunk, config["num_chunks_in_group"],
                        shuffle_prob=config.get("image_shuffle_prob", 0.5),
                        shuffle_offset=config.get("shuffle_offset", 16), rng=rng)


# ----------------------------------------------------------------------
# the async loader
# ----------------------------------------------------------------------
class _ProducerError:
    """Exception carrier across the producer queue (re-raised in the
    consumer so loader errors cannot masquerade as end-of-stream)."""

    def __init__(self, exc: BaseException):
        self.exc = exc


def _read_file(path: str) -> Tuple[bytes, List[Tuple[int, int]]]:
    """A tfrecord file's bytes and its records' (offset, length) spans."""
    spans = record_spans(path)
    with _open(path, "rb") as f:
        return f.read(), spans


class _RecordReader:
    """Record bytes by (file index, record index), in the interleave's
    order: a file is read whole when one of its records is first asked for
    and dropped after its last, so at most ``cycle_length`` files are held."""

    def __init__(self, files: Sequence[str]):
        self.files = files
        self.held: Dict[int, Tuple[bytes, List[Tuple[int, int]]]] = {}

    def __call__(self, ref: Tuple[int, int]) -> bytes:
        f, i = ref
        if f not in self.held:
            self.held[f] = _read_file(self.files[f])
        raw, spans = self.held[f]
        if i == len(spans) - 1:
            del self.held[f]
        off, length = spans[i]
        return raw[off:off + length]

    def read_all(self, refs: Sequence[Tuple[int, int]]) -> List[bytes]:
        """The records at ``refs`` (in any order, repeats allowed), one read
        of each file they name; nothing is held afterwards."""
        by_file: Dict[int, set] = {}
        for f, i in refs:
            by_file.setdefault(f, set()).add(i)
        got = {}
        for f, idx in by_file.items():
            raw, spans = _read_file(self.files[f])
            for i in idx:
                off, length = spans[i]
                got[f, i] = raw[off:off + length]
        return [got[r] for r in refs]


class PretrainLoader:
    """Tfrecord -> batch pipeline with a bounded prefetch queue, the
    examples parsed on a pool of ``num_threads`` threads.

    Iterate to get numpy batches, or call ``batches(start)`` to begin at a
    later batch; wrap with ``device_iterator`` for double-buffered
    host->device transfer.
    """

    def __init__(self, files: Sequence[str], config: Dict[str, Any],
                 batch_size: int, is_training: bool = True,
                 host_id: int = 0, num_hosts: int = 1,
                 num_threads: int = 8, shuffle_buffer: int = 256,
                 prefetch: int = 2, seed: int = 0,
                 repeat: Optional[bool] = None,
                 cycle_length: int = 16):
        self.files = shard_files(files, host_id, num_hosts,
                                 shuffle=is_training, seed=seed)
        if not self.files:
            raise ValueError("no input files")
        self.config = config
        self.batch_size = batch_size
        self.is_training = is_training
        # never oversubscribe the host: the parse work is numpy-CPU-bound,
        # and more pool threads than cores THRASHES (measured on a 1-core
        # host: 181 seg/s at 1 thread vs 12.7 at 4 — GIL + cache churn);
        # on real TPU hosts (>10 cores) the requested count stands.
        # sched_getaffinity = cores actually ALLOTTED to this process
        # (cgroup/container limits), not the machine total
        import os as _os
        try:
            avail = len(_os.sched_getaffinity(0))
        except AttributeError:  # non-Linux
            avail = _os.cpu_count() or num_threads
        self.num_threads = max(1, min(num_threads, avail))
        self.shuffle_buffer = shuffle_buffer if is_training else 0
        self.prefetch = prefetch
        self.seed = seed
        self.repeat = is_training if repeat is None else repeat
        self.cycle_length = cycle_length
        self._counts: Dict[int, int] = {}  # records per file, from its headers

    def _record_refs(self) -> Iterator[Tuple[int, int]]:
        """(file index, record index) of every record in stream order.
        Interleave over at most ``cycle_length`` files at a time, pulling
        the next file as one exhausts — bounded open handles at
        thousands-of-shards scale, like the reference's parallel_interleave
        (model/dataloader.py:174-178). A file's records are counted from its
        headers when it joins the cycle."""
        while True:
            todo = list(range(len(self.files)))
            active: List[List[int]] = []  # [file, next record, records]
            while todo or active:
                while todo and len(active) < self.cycle_length:
                    f = todo.pop(0)
                    if f not in self._counts:
                        self._counts[f] = len(record_spans(self.files[f]))
                    active.append([f, 0, self._counts[f]])
                for a in list(active):
                    if a[1] == a[2]:
                        active.remove(a)
                        continue
                    a[1] += 1
                    yield a[0], a[1] - 1
            if not self.repeat:
                return

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self.batches()

    def batches(self, start: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        """The batches from the ``start``-th on: those that iterating from
        the first and dropping ``start`` gives. The records of the batches
        passed over are never read or parsed: the shuffle buffer holds their
        positions, each record's generator is spawned by its index, and the
        collate rng draws what a collate would (``skip_collate``). So a run
        resumed at step k pays for counting k batches' records, not for
        parsing them."""
        rng = np.random.default_rng(self.seed)
        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        # one source record makes unbatch_size examples: whole groups of
        # batch_size records are passed over, the rest parsed and dropped
        unbatch = self.config.get("unbatch_size", 1)
        groups, drop = divmod(start, unbatch)
        skip = groups * self.batch_size  # records passed over

        def guarded_put(item) -> bool:
            """put() that never deadlocks a daemon thread: rechecks stop
            while the queue is full (the consumer may have abandoned us)."""
            while not stop.is_set():
                try:
                    out_q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            pool = None
            try:
                pool = ThreadPoolExecutor(self.num_threads)
                read = _RecordReader(self.files)
                passing = [skip > 0]

                def stream():
                    for ref in self._record_refs():
                        yield ref if passing[0] else read(ref)

                buf: List[Any] = []
                records = shuffle_records(stream(), self.shuffle_buffer, rng, buf)
                for n, _ in enumerate(itertools.islice(records, skip)):
                    if stop.is_set():
                        return
                    if (n + 1) % self.batch_size == 0:
                        for _ in range(unbatch):
                            skip_collate(self.batch_size, self.config, rng,
                                         self.is_training)
                passing[0] = False
                buf[:] = read.read_all(buf)

                ready: List[Dict[str, np.ndarray]] = []  # parsed (sub)examples
                pending: List = []
                dropped = 0
                # one child Generator per task: np.random.Generator is NOT
                # thread-safe, and more tasks than generators can be in
                # flight at once. A record's child is the spawn of its index.
                seed_seq = np.random.SeedSequence(self.seed + 1, n_children_spawned=skip)
                for rec in records:
                    if stop.is_set():
                        break
                    (child,) = seed_seq.spawn(1)
                    pending.append(pool.submit(parse_pretrain_example, rec, self.config,
                                               np.random.default_rng(child),
                                               self.is_training))
                    if len(pending) >= self.batch_size:
                        for p in pending[:self.batch_size]:
                            r = p.result()
                            # unbatch_size>1 splits one source example into
                            # independent examples (reference unbatches then
                            # re-batches, model/dataloader.py:190-207) — the
                            # emitted batch size stays batch_size
                            ready.extend(r if isinstance(r, list) else [r])
                        pending = pending[self.batch_size:]
                        while len(ready) >= self.batch_size:
                            batch = collate_pretrain_batch(
                                ready[:self.batch_size], self.config, rng,
                                self.is_training)
                            ready = ready[self.batch_size:]
                            if dropped < drop:
                                dropped += 1
                            elif not guarded_put(batch):
                                break
                guarded_put(None)
            except BaseException as e:
                # re-raise in the consumer — a swallowed parse/collate
                # error would read as a clean end-of-stream and silently
                # truncate training
                guarded_put(_ProducerError(e))
            finally:
                # shut down on EVERY exit (success, error, stop): without
                # this, in-flight parse futures keep burning CPU after an
                # error is handed to a consumer that catches it
                if pool is not None:
                    pool.shutdown(wait=False, cancel_futures=True)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                batch = out_q.get()
                if batch is None:
                    return
                if isinstance(batch, _ProducerError):
                    raise batch.exc
                yield batch
        finally:
            stop.set()


# how long closing a device_iterator waits for its worker
WORKER_JOIN_S = 30.0


def device_iterator(it: Iterator[Dict[str, np.ndarray]], device="cuda",
                    images_bf16: bool = True, images_u8: bool = False
                    ) -> Iterator[Dict[str, torch.Tensor]]:
    """Host batches -> torch tensors on ``device``, prepared on a worker
    thread one batch ahead of the consumer (the infeed-queue analogue).

    images_bf16 casts the float images to bf16 on the host (halves the
    copy's bytes; the model's first conv casts to bf16 anyway). images_u8
    quantizes them to uint8 instead (1 B/px, dequantized in the backbone;
    rounded to 1/255 steps, so not bit-identical).

    On a CUDA device each batch lands in pinned host memory and is copied
    with ``non_blocking=True`` on a side stream, so the copy overlaps the
    step. The consumer's stream waits on the copy's event, and
    ``record_stream`` keeps the allocator from reusing a device buffer
    while the consumer's stream may still read it; the pinned buffers come
    from torch's caching host allocator, which does not hand a block out
    again before its copy has finished. Errors of the worker (the loader's
    included) are raised again in the consumer. Closing the iterator (or
    dropping it) stops the worker and waits for it, up to
    ``WORKER_JOIN_S`` seconds, then warns that it still runs."""
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    side = torch.cuda.Stream(dev) if cuda else None

    def prep(batch) -> Dict[str, torch.Tensor]:
        out = {}
        for k, v in batch.items():
            v = np.ascontiguousarray(v)
            if k == "images" and images_u8:
                v = np.clip(np.round(v * 255.0), 0, 255).astype(np.uint8)
            t = torch.from_numpy(v)
            if k == "images" and images_bf16 and not images_u8:
                dst = torch.empty(t.shape, dtype=torch.bfloat16, pin_memory=cuda)
                t = dst.copy_(t)
            elif cuda:
                t = t.pin_memory()
            out[k] = t
        return out

    def move(host):
        if not cuda:
            return host, None
        with torch.cuda.stream(side):
            moved = {k: v.to(dev, non_blocking=True) for k, v in host.items()}
            done = torch.cuda.Event()
            done.record(side)
        return moved, done

    # maxsize=1: one batch queued, one in the worker, one with the consumer
    q: "queue.Queue" = queue.Queue(maxsize=1)
    stop = threading.Event()

    def send(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for batch in it:
                if not send(("batch", move(prep(batch)))):
                    return
            send(("end", None))
        except BaseException as e:  # re-raised in the consumer: a swallowed
            send(("error", e))      # loader or copy error would truncate training

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            kind, payload = q.get()
            if kind == "error":
                raise payload
            if kind == "end":
                return
            batch, done = payload
            if done is not None:
                consumer = torch.cuda.current_stream(dev)
                consumer.wait_event(done)
                for v in batch.values():
                    v.record_stream(consumer)
            yield batch
    finally:
        # the worker may be inside torch (a pin or a copy): wait for it, so
        # that none runs on into the interpreter's exit (a CLI that returned
        # with it mid-copy was aborted by std::terminate on the card)
        # (stop is read between batches: one stuck in the loader's next()
        # is named, not waited for without end)
        stop.set()
        t.join(WORKER_JOIN_S)
        if t.is_alive():
            warnings.warn(f"device_iterator: the loader's worker still runs "
                          f"{WORKER_JOIN_S} s after close", RuntimeWarning, stacklevel=2)
