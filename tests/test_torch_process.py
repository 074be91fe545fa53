"""The port's offline corpus pipeline (merlot_tpu_torch.data.process and
data.video) against the JAX package's on the CPU, on the same inputs.

Everything is compared exactly: edit distances, DTW paths, alignments,
cleaned text, chunks, black-bar boxes, sizes, the frames decoded from one
cv2-written video, the ffmpeg commands (``shutil.which`` and
``subprocess.run`` replaced in both modules), the shuffling writer's bytes
under one ``random.seed``, both process CLIs' shards on the same video and
JSON, and the port's ``PretrainLoader`` batches from the port's shard
against JAX's loader's.
"""

import json
import random
import subprocess

import numpy as np
import pytest

from merlot_tpu.data import pretrain_loader as jax_loader
from merlot_tpu.data import process as jax_process
from merlot_tpu.data import video as jax_video
from merlot_tpu.data.tfrecord import read_tfrecords as jax_read_tfrecords
from merlot_tpu_torch.data import pretrain_loader, process, video
from merlot_tpu_torch.data.tfrecord import read_tfrecords

VOCAB = ["the", "quick", "brown", "fox", "jumps", "over", "a", "lazy", "dog", "and",
         "runs", "far", "away", "now.", "is", "it?", "yes!", "pancake", "waffle"]


def _words(rng, n):
    return [VOCAB[i] for i in rng.integers(0, len(VOCAB), n)]


@pytest.mark.parametrize("a,b", [("kitten", "sitting"), ("", "abc"), ("same", "same"),
                                 ("pancakewaffle", "pancake"), ("abc", "")])
def test_edit_distance_matches_jax(a, b):
    assert process.edit_distance(a, b) == jax_process.edit_distance(a, b)


@pytest.mark.parametrize("seed,shape", [(0, (7, 9)), (1, (12, 5)), (2, (1, 6)), (3, (10, 10))])
def test_dtw_path_matches_jax(seed, shape):
    # small integer costs: many ties, which the tie order must break alike
    cost = np.random.default_rng(seed).integers(0, 3, shape).astype(np.float32)
    assert process.dtw_path(cost) == jax_process.dtw_path(cost)


@pytest.mark.parametrize("case", ["merged", "identity", "noisy"])
def test_align_using_dtw_matches_jax(case):
    rng = np.random.default_rng(4)
    if case == "merged":
        asr = ["much", "of", "a", "pancake", "waffle", "person", "so"]
        den = ["much", "of", "a", "pancakewaffle", "person", "so."]
    elif case == "identity":
        asr = den = _words(rng, 20)
    else:
        asr = _words(rng, 80)
        den = [w.upper() if i % 5 else w + "s" for i, w in enumerate(asr) if i % 7]
    got = process.align_using_dtw(asr, den)
    assert got == jax_process.align_using_dtw(asr, den)
    assert len(got) == len(asr)


def test_cleanups_match_jax():
    subs = [{"word": "&gt;", "time": 0.0}, {"word": "hello", "time": 1.0},
            {"word": "x;", "time": 2.0}, {"word": "", "time": 3.0},
            {"word": "wörld", "time": 4.0}]
    assert process.clean_subtitles(subs) == jax_process.clean_subtitles(subs)
    for text in ["check https://example.com/x?y=1   now\n\n\nok",
                 "  www.test.org/a  and   more \n \n words  ", "plain"]:
        assert process.clean_description(text) == jax_process.clean_description(text)
        assert process.fix_text(text) == jax_process.fix_text(text)


def _item(seed: int, n_words: int, step: float, duration: float, vid: str) -> dict:
    rng = np.random.default_rng(seed)
    words = _words(rng, n_words)
    return {"subtitles": [{"word": w, "time": step * i} for i, w in enumerate(words)],
            "denoised": [{"cleanasr": " ".join(words[:n_words // 2])},
                         {"cleanasr": " ".join(w.capitalize() for w in words[n_words // 2:])}],
            "info": {"id": vid, "title": "a test video", "duration": duration}}


@pytest.mark.parametrize("seed,n_words,duration", [(5, 60, 100.0), (6, 200, 30.0)])
def test_split_video_into_chunks_matches_jax(seed, n_words, duration):
    item = _item(seed, n_words, 0.25, duration, "v")
    got = process.split_video_into_chunks(item)
    want = jax_process.split_video_into_chunks(item)
    assert len(got) == len(want) > 1
    for a, b in zip(got, want):
        assert {k: list(v) if isinstance(v, list) else v for k, v in a.items()} == \
               {k: list(v) if isinstance(v, list) else v for k, v in b.items()}


@pytest.mark.parametrize("buffer_size,faithful_drop,n", [(1, False, 30), (100, False, 500),
                                                         (100, True, 500), (20, True, 7)])
def test_shuffling_writer_bytes_match_jax(tmp_path, buffer_size, faithful_drop, n):
    paths = {}
    for name, mod in (("port", process), ("jax", jax_process)):
        paths[name] = tmp_path / f"{name}.tfrecord"
        random.seed(11)
        with mod.ShufflingTFRecordWriter(str(paths[name]), buffer_size=buffer_size,
                                         faithful_drop=faithful_drop) as w:
            for i in range(n):
                w.write(f"rec{i:04d}".encode())
    assert paths["port"].read_bytes() == paths["jax"].read_bytes()
    kept = list(read_tfrecords(str(paths["port"])))
    assert (len(kept) < n) if (faithful_drop and n > buffer_size) else (len(kept) == n)


def test_black_bars_and_sizes_match_jax():
    rng = np.random.default_rng(7)
    frames = np.zeros((3, 100, 80, 3), np.uint8)
    frames[:, 10:90, 5:75] = rng.integers(20, 255, (3, 80, 70, 3), np.uint8)
    for thresh, perc in ((16, 0.2), (32, 0.2), (128, 0.05)):
        assert video.detect_black_bars(frames, thresh, perc) == \
               jax_video.detect_black_bars(frames, thresh, perc)
    empty = np.zeros((1, 40, 60, 3), np.uint8)
    assert video.detect_black_bars(empty) == jax_video.detect_black_bars(empty)
    for size in ((1280, 720), (1120, 630), (640, 640), (300, 200), (720, 1280), (385, 2000)):
        assert video.get_size_for_resize(size) == jax_video.get_size_for_resize(size)
    assert video.get_size_for_resize((1120, 630)) == (512, 288)


def _write_video(path, frames: int, hw=(96, 128), bars=(16, 8), fps=4.0, seed=0):
    """An mp4 (cv2's mp4v) of noise frames inside black bars (rows, cols)."""
    import cv2
    h, w = hw
    by, bx = bars
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    assert writer.isOpened()
    rng = np.random.default_rng(seed)
    for _ in range(frames):
        frame = np.zeros((h, w, 3), np.uint8)
        frame[by:h - by, bx:w - bx] = rng.integers(60, 255, (h - 2 * by, w - 2 * bx, 3),
                                                   np.uint8)
        writer.write(frame)
    writer.release()


def _no_ffmpeg(monkeypatch):
    for mod in (video, jax_video):
        monkeypatch.setattr(mod.shutil, "which", lambda name: None)


def test_cv2_frames_match_jax(tmp_path, monkeypatch):
    _no_ffmpeg(monkeypatch)
    vf = tmp_path / "v.mp4"
    _write_video(vf, 24)
    assert video.frame_route() == "cv2"
    times = [0.1, 1.3, 2.2, 4.9]
    got = video.extract_frames_from_video(str(vf), times)
    np.testing.assert_array_equal(got, jax_video.extract_frames_from_video(str(vf), times))
    assert got.shape[1:] == (96 - 32, 128 - 16, 3)
    np.testing.assert_array_equal(video.extract_single_frame(str(vf), 1.3),
                                  jax_video.extract_single_frame(str(vf), 1.3))
    np.testing.assert_array_equal(video.extract_all_frames(str(vf), fps=2.0),
                                  jax_video.extract_all_frames(str(vf), fps=2.0))
    assert video.extract_frames_from_video(str(tmp_path / "missing.mp4"), times) is None


def test_ffmpeg_commands_match_jax(monkeypatch):
    """The ffmpeg route's commands and frames, from a fake ffmpeg/ffprobe
    that answers every command with a frame of its own (both modules share
    ``shutil`` and ``subprocess``: each package runs in turn)."""
    w, h = 20, 12
    log = []

    def run(cmd, capture_output=False, check=False, text=False):
        log.append(list(cmd))
        if cmd[0] == "ffprobe":
            out = f"{w},{h}\n"
        else:
            seed = sum(map(ord, " ".join(cmd)))
            n = 3 if "-vf" in cmd else 1
            out = np.random.default_rng(seed).integers(0, 255, n * h * w * 3,
                                                       np.uint8).tobytes()
        return subprocess.CompletedProcess(cmd, 0, stdout=out, stderr="")

    monkeypatch.setattr(video.shutil, "which", lambda prog: f"/usr/bin/{prog}")
    monkeypatch.setattr(video.subprocess, "run", run)
    assert video.frame_route() == "ffmpeg"
    times = [0.5, 1.25, 3.0, 7.125, 9.0]
    calls, frames = {}, {}
    for name, mod in (("port", video), ("jax", jax_video)):
        log.clear()
        frames[name] = [mod.extract_frames_from_video("v.mp4", times, use_multithreading=t)
                        for t in (True, False)]
        frames[name] += [mod.extract_single_frame("v.mp4", 2.5),
                         mod.extract_all_frames("v.mp4", fps=1.0)]
        calls[name] = sorted(log)
    assert calls["port"] == calls["jax"]
    for a, b in zip(frames["port"], frames["jax"]):
        np.testing.assert_array_equal(a, b)
    assert frames["port"][0].shape == (5, h, w, 3)
    assert ["ffmpeg", "-ss", "7.125", "-threads", "1", "-i", "v.mp4", "-frames:v", "1",
            "-q:v", "2", "-f", "rawvideo", "-pix_fmt", "rgb24", "-v", "error",
            "pipe:1"] in calls["port"]


CONFIG = {
    "num_chunks": 4, "image_size": [64, 96], "chunk_text_len": 16,
    "clean_asr_prob": 0.5, "augment_prob": 0.8, "shuffle_chunks": True,
    "num_chunks_in_group": 2, "image_shuffle_prob": 0.5,
    "random_scale_max": 1.5, "random_scale_min": 1.125,
}


@pytest.fixture(scope="module")
def cli_shards(tmp_path_factory):
    """Two cv2-written videos and their .grover.json through both process
    CLIs (the cv2 route, the same random.seed)."""
    d = tmp_path_factory.mktemp("corpus")
    vids = []
    for i, (frames, bars) in enumerate(((120, (16, 8)), (80, (8, 16)))):
        vf = d / f"vid{i}.mp4"
        _write_video(vf, frames, bars=bars, seed=i)
        item = _item(10 + i, 2 * frames, 0.1, frames / 4.0, f"vid{i:02d}")
        (d / f"vid{i}.grover.json").write_text(json.dumps(item))
        vids.append(str(vf))
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        _no_ffmpeg(mp)
        for name, mod in (("port", process), ("jax", jax_process)):
            out[name] = str(d / f"{name}.tfrecord")
            random.seed(3)
            mod.main(["--videos", *vids, "--out", out[name], "--num_chunks", "4",
                      "--shuffle_buffer", "10"])
    return out


def test_process_cli_shards_match_jax(cli_shards):
    got = open(cli_shards["port"], "rb").read()
    assert got == open(cli_shards["jax"], "rb").read()
    records = list(read_tfrecords(cli_shards["port"]))
    assert len(records) >= 4
    assert records == list(jax_read_tfrecords(cli_shards["jax"]))


@pytest.mark.parametrize("is_training", [True, False], ids=["train", "eval"])
def test_loader_on_the_port_shard_matches_jax(cli_shards, is_training):
    kw = dict(batch_size=2, is_training=is_training, num_threads=2, shuffle_buffer=4,
              seed=5, repeat=is_training)
    got = iter(pretrain_loader.PretrainLoader([cli_shards["port"]], CONFIG, **kw))
    want = iter(jax_loader.PretrainLoader([cli_shards["port"]], CONFIG, **kw))
    n = 0
    for a, b in zip(got, want):
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        n += 1
        if n == 2:
            break
    assert n == 2
    got.close()
