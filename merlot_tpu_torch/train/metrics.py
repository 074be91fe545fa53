"""Metrics logging: JSONL + native TensorBoard event files, no TF
(counterpart of merlot_tpu/train/metrics.py).

Replaces the reference's device->host outfeed host-call that wrote TF
summaries (utils/model_utils.py:474-519): the train loop copies the small
metrics dict to the host every ``log_every`` steps and hands it here. Tags
are written sorted by namespace depth then name, like the reference's
summary ordering (:506-508).

The TensorBoard writer emits real ``events.out.tfevents.*`` files by
serializing Event/Summary protos with the same minimal wire helpers as the
tfrecord module, and ``read_events`` parses them back.
"""

from __future__ import annotations

import json
import os
import socket
import struct
import time
from typing import Any, Dict, List, Optional

from merlot_tpu_torch.data.tfrecord import (TFRecordWriter, _read_varint,
                                            _skip_field, _write_len_delimited,
                                            _write_tag, _write_varint,
                                            read_tfrecords)


def _encode_summary_value(tag: str, value: float) -> bytes:
    out = bytearray()
    _write_len_delimited(out, 1, tag.encode("utf-8"))      # Value.tag
    _write_tag(out, 2, 5)                                  # Value.simple_value
    out.extend(struct.pack("<f", float(value)))
    return bytes(out)


def _encode_event(step: int, metrics: Optional[Dict[str, float]] = None,
                  wall_time: Optional[float] = None,
                  file_version: Optional[str] = None) -> bytes:
    out = bytearray()
    _write_tag(out, 1, 1)                                  # Event.wall_time
    out.extend(struct.pack("<d", wall_time if wall_time is not None
                           else time.time()))
    _write_tag(out, 2, 0)                                  # Event.step
    _write_varint(out, step & 0xFFFFFFFFFFFFFFFF)
    if file_version is not None:
        _write_len_delimited(out, 3, file_version.encode("utf-8"))
    if metrics:
        summary = bytearray()
        for tag in sorted(metrics, key=lambda t: (len(t.split("/")), t)):
            _write_len_delimited(summary, 1,
                                 _encode_summary_value(tag, metrics[tag]))
        _write_len_delimited(out, 5, bytes(summary))       # Event.summary
    return bytes(out)


def _parse_summary_value(buf: bytes):
    pos, tag, value = 0, None, None
    while pos < len(buf):
        key, pos = _read_varint(buf, pos)
        field, wire = key >> 3, key & 7
        if field == 1 and wire == 2:
            n, pos = _read_varint(buf, pos)
            tag = buf[pos:pos + n].decode("utf-8")
            pos += n
        elif field == 2 and wire == 5:
            (value,) = struct.unpack("<f", buf[pos:pos + 4])
            pos += 4
        else:
            pos = _skip_field(buf, pos, wire)
    return tag, value


def parse_event(payload: bytes) -> Dict[str, Any]:
    """One serialized Event -> {'wall_time', 'step', 'file_version'?,
    'summary': {tag: simple_value}} (the fields this module writes)."""
    out: Dict[str, Any] = {"step": 0, "summary": {}}
    pos = 0
    while pos < len(payload):
        key, pos = _read_varint(payload, pos)
        field, wire = key >> 3, key & 7
        if field == 1 and wire == 1:
            (out["wall_time"],) = struct.unpack("<d", payload[pos:pos + 8])
            pos += 8
        elif field == 2 and wire == 0:
            out["step"], pos = _read_varint(payload, pos)
        elif field in (3, 5) and wire == 2:
            n, pos = _read_varint(payload, pos)
            body = payload[pos:pos + n]
            pos += n
            if field == 3:
                out["file_version"] = body.decode("utf-8")
                continue
            spos = 0
            while spos < len(body):
                skey, spos = _read_varint(body, spos)
                if skey >> 3 == 1 and skey & 7 == 2:
                    vn, spos = _read_varint(body, spos)
                    tag, value = _parse_summary_value(body[spos:spos + vn])
                    out["summary"][tag] = value
                    spos += vn
                else:
                    spos = _skip_field(body, spos, skey & 7)
        else:
            pos = _skip_field(payload, pos, wire)
    return out


def read_events(path: str) -> List[Dict[str, Any]]:
    """Every Event of an ``events.out.tfevents.*`` file, CRCs checked."""
    return [parse_event(r) for r in read_tfrecords(path, verify_crc=True)]


class TensorBoardWriter:
    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        fname = (f"events.out.tfevents.{int(time.time())}."
                 f"{socket.gethostname()}.{os.getpid()}")
        self._w = TFRecordWriter(os.path.join(logdir, fname))
        self._w.write(_encode_event(0, file_version="brain.Event:2"))

    def write(self, step: int, metrics: Dict[str, float]) -> None:
        self._w.write(_encode_event(step, metrics))

    def flush(self) -> None:
        self._w._f.flush()

    def close(self) -> None:
        self._w.close()


class MetricsLogger:
    """JSONL + TensorBoard + stdout, with steps/sec tracking."""

    def __init__(self, output_dir: str, also_tensorboard: bool = True,
                 name: str = "train"):
        os.makedirs(output_dir, exist_ok=True)
        self._jsonl = open(os.path.join(output_dir, f"{name}_metrics.jsonl"), "a")
        self._tb = TensorBoardWriter(os.path.join(output_dir, name)) \
            if also_tensorboard else None
        self._last_time = None
        self._last_step = None

    def log(self, step: int, metrics: Dict[str, Any],
            echo: bool = True) -> None:
        now = time.time()
        scalars = {k: float(v) for k, v in metrics.items()}
        if self._last_time is not None and step > self._last_step:
            scalars["steps_per_sec"] = ((step - self._last_step)
                                        / (now - self._last_time))
        self._last_time, self._last_step = now, step

        self._jsonl.write(json.dumps({"step": step, "time": now, **scalars})
                          + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            self._tb.write(step, scalars)
            self._tb.flush()
        if echo:
            keys = sorted(scalars)[:8]
            msg = " ".join(f"{k}={scalars[k]:.4g}" for k in keys)
            print(f"[step {step}] {msg}", flush=True)

    def close(self):
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
