"""merlot_tpu_torch's data path (tfrecord, the native extension, JPEG,
image_ops, the pretrain loader, the device iterator) vs merlot_tpu's on the
CPU, at small sizes.

Everything here is compared bit for bit (no tolerance): the record bytes,
the parsed Examples, the resized, padded and augmented images with the
same rng, the decoded JPEGs (both packages decode with libjpeg here, and
the port's pil route gives the same pixels; CMYK JPEGs go to PIL in both)
and the loader's batches for the same files, config and seed.
"""

import io
import itertools
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from merlot_tpu.data import image_ops as jax_image_ops
from merlot_tpu.data import pretrain_loader as jax_loader
from merlot_tpu.data import tfrecord as jax_tfrecord
from merlot_tpu.data.make_synthetic_tfrecord import write_synthetic_shard as jax_write_shard
from merlot_tpu_torch.data import _native, image_ops, pretrain_loader, tfrecord
from merlot_tpu_torch.data.make_synthetic_tfrecord import write_synthetic_shard

FIXTURE = (Path(__file__).resolve().parents[1] / "merlot_tpu_torch" / "assets"
           / "jpeg_fixture.npz")

CONFIG = {
    "num_chunks": 4, "image_size": [64, 96], "chunk_text_len": 16,
    "clean_asr_prob": 0.5, "augment_prob": 0.8, "shuffle_chunks": True,
    "num_chunks_in_group": 2, "image_shuffle_prob": 0.5,
    "random_scale_max": 1.5, "random_scale_min": 1.125,
}
FEATURES = {"img": b"\x00\x01binary\xff", "toks": [1, 5, 50000, 0, 2 ** 40],
            "neg": [-3, -1], "floats": [1.5, -2.25, 1e-30], "name": "hello",
            "names": [b"a", b"bc"]}


def test_crc32c_known_vectors(monkeypatch):
    # public CRC-32C (Castagnoli) vectors, native and pure-python
    vectors = {b"": 0, b"123456789": 0xE3069283, b"a": 0xC1D04330,
               bytes(32): 0x8A9136AA}
    assert _native.load() is not None, _native.build_error()
    for data, want in vectors.items():
        assert tfrecord.crc32c(data) == want
    monkeypatch.setattr(_native, "load", lambda: None)
    for data, want in vectors.items():
        assert tfrecord.crc32c(data) == want
        assert tfrecord.masked_crc(data) == jax_tfrecord.masked_crc(data)


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
def test_tfrecord_bytes_and_examples_match_jax(tmp_path, monkeypatch, native):
    if not native:
        monkeypatch.setattr(_native, "load", lambda: None)
    payloads = [tfrecord.encode_example(FEATURES),
                tfrecord.encode_example({"k": [3.0], "z": b""})]
    assert payloads == [jax_tfrecord.encode_example(FEATURES),
                        jax_tfrecord.encode_example({"k": [3.0], "z": b""})]
    ours, theirs = tmp_path / "ours.tfrecord", tmp_path / "theirs.tfrecord"
    with tfrecord.TFRecordWriter(str(ours)) as w:
        for p in payloads:
            w.write(p)
    with jax_tfrecord.TFRecordWriter(str(theirs)) as w:
        for p in payloads:
            w.write(p)
    assert ours.read_bytes() == theirs.read_bytes()
    got = list(tfrecord.read_tfrecords(str(theirs), verify_crc=True))
    assert got == payloads
    raw = theirs.read_bytes()
    spans = tfrecord.record_spans(str(theirs))
    assert [raw[o:o + n] for o, n in spans] == payloads
    (tmp_path / "cut.tfrecord").write_bytes(raw[:-3])
    with pytest.raises(IOError, match="truncated"):
        tfrecord.record_spans(str(tmp_path / "cut.tfrecord"))
    for p in payloads:
        a, b = tfrecord.parse_example(p), jax_tfrecord.parse_example(p)
        assert a.keys() == b.keys()
        for k in a:
            if isinstance(a[k], list):
                assert a[k] == b[k], k
            else:
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    bad = bytearray(ours.read_bytes())
    bad[9] ^= 1  # the first length crc (the native scan checks only these)
    ours.write_bytes(bytes(bad))
    with pytest.raises(IOError):
        list(tfrecord.read_tfrecords(str(ours), verify_crc=True))


def test_jpeg_fixture_decodes_bit_for_bit():
    """The committed fixture: three JPEGs made with PIL (4:2:0 q80, 4:4:4
    q95 noise, 4:2:2 q75 at an odd size) and the pixels PIL decoded from
    them. The port's decode (libjpeg here) and JAX's equal them exactly."""
    assert _native.jpeg_route() == "libjpeg"
    with np.load(FIXTURE) as z:
        for i in range(3):
            data = z[f"jpeg{i}"].tobytes()
            want = z[f"pixels{i}"]
            np.testing.assert_array_equal(image_ops.decode_jpeg_u8(data), want)
            np.testing.assert_array_equal(jax_image_ops.decode_jpeg_u8(data), want)
            PIL = pytest.importorskip("PIL.Image")
            np.testing.assert_array_equal(
                np.asarray(PIL.open(io.BytesIO(data)).convert("RGB")), want)


@pytest.mark.parametrize("quality", [80, 95])
def test_jpeg_encode_equals_pil(quality):
    """libjpeg's encoder as the synthetic writer calls it (4:2:0, baseline)
    writes the bytes PIL writes for the same frame and quality."""
    from merlot_tpu_torch.data.make_synthetic_tfrecord import smooth_frame
    PIL = pytest.importorskip("PIL.Image")
    frame = smooth_frame(np.random.default_rng(0), 48, 80)
    data = _native.encode_jpeg(frame, quality=quality)
    buf = io.BytesIO()
    PIL.fromarray(frame).save(buf, format="JPEG", quality=quality)
    assert data == buf.getvalue()
    np.testing.assert_array_equal(image_ops.decode_jpeg_u8(data),
                                  jax_image_ops.decode_jpeg_u8(data))


def test_no_jpeg_route_names_what_is_missing(monkeypatch):
    monkeypatch.setattr(_native, "_state", {})
    monkeypatch.setattr(_native, "load", lambda: None)
    monkeypatch.setattr(_native, "_have_pil", lambda: False)
    monkeypatch.setattr(_native, "_nvjpeg_header", lambda: None)
    with pytest.raises(RuntimeError, match="jpeglib.h.*PIL.*nvjpeg.h"):
        _native.jpeg_route()


def _pil_jpeg(mode: str, size=(48, 64)) -> bytes:
    """A seeded noise JPEG that PIL writes in ``mode`` (CMYK, L)."""
    PIL = pytest.importorskip("PIL.Image")
    rng = np.random.default_rng(4)
    rgb = rng.integers(0, 256, (*size, 3), dtype=np.uint8)
    buf = io.BytesIO()
    PIL.fromarray(rgb).convert(mode).save(buf, format="JPEG", quality=90)
    return buf.getvalue()


def _by_route(route, fn, *args):
    """fn(*args) with JPEGs taken by ``route``, then the default again."""
    _native.set_jpeg_route(route)
    try:
        return fn(*args)
    finally:
        _native.set_jpeg_route(None)


@pytest.mark.parametrize("mode", ["CMYK", "L"])
def test_decode_jpeg_colourspaces_match_jax(mode):
    """A CMYK JPEG (libjpeg refuses it: PIL decodes it, as JAX's
    decode_jpeg_u8 does) and a grayscale one decode as JAX's do, bit for
    bit, by the default route and by the pil route."""
    data = _pil_jpeg(mode)
    want = jax_image_ops.decode_jpeg_u8(data)
    assert want.shape == (48, 64, 3)
    np.testing.assert_array_equal(image_ops.decode_jpeg_u8(data), want)
    np.testing.assert_array_equal(_by_route("pil", _native.decode_jpeg, data), want)
    if mode == "CMYK":
        with pytest.raises(ValueError):
            _native.load().decode_jpeg(data)


def test_undecodable_jpeg_still_raises():
    with pytest.raises(Exception):
        image_ops.decode_jpeg_u8(b"\xff\xd8 not a jpeg")


def test_pil_route_equals_libjpeg_on_fixture():
    """The pil route decodes the committed fixture exactly as the libjpeg
    route does, and encodes the bytes libjpeg writes."""
    pytest.importorskip("PIL.Image")
    with np.load(FIXTURE) as z:
        for i in range(3):
            data = z[f"jpeg{i}"].tobytes()
            np.testing.assert_array_equal(_by_route("pil", _native.decode_jpeg, data),
                                          _by_route("libjpeg", _native.decode_jpeg, data))
            np.testing.assert_array_equal(_by_route("pil", _native.decode_jpeg, data),
                                          z[f"pixels{i}"])
    frame = np.random.default_rng(2).integers(0, 256, (40, 56, 3), dtype=np.uint8)
    assert (_by_route("pil", _native.encode_jpeg, frame, 85)
            == _by_route("libjpeg", _native.encode_jpeg, frame, 85))


def test_jpeg_route_without_libjpeg_is_pil_and_nvjpeg_only_by_name(monkeypatch):
    """Without jpeglib.h the default route is pil; nvJPEG is taken only
    when named (and the name is refused where nvJPEG cannot be built)."""
    pytest.importorskip("PIL.Image")
    monkeypatch.setattr(_native, "_state", {})
    monkeypatch.setattr(_native, "have_libjpeg", lambda: False)
    monkeypatch.setattr(_native, "load", lambda: None)
    monkeypatch.setattr(_native, "_nvjpeg_header", lambda: Path("/nvjpeg.h"))
    built = []
    monkeypatch.setattr(_native, "_nvjpeg_lib", lambda: built.append(1))
    assert _native.jpeg_route() == "pil"
    assert not built
    _native.set_jpeg_route("nvjpeg")
    assert _native.jpeg_route() == "nvjpeg" and built
    _native.set_jpeg_route(None)
    assert _native.jpeg_route() == "pil"
    with pytest.raises(RuntimeError, match="libjpeg"):
        _native.set_jpeg_route("libjpeg")
    with pytest.raises(ValueError, match="unknown"):
        _native.set_jpeg_route("turbo")


@pytest.mark.parametrize("method", ["bilinear", "nearest", "bicubic", "area", "random"])
@pytest.mark.parametrize("src_dtype", ["u8", "f32"])
def test_resize_and_pad_matches_jax(method, src_dtype):
    rng = np.random.default_rng(1)
    u8 = rng.integers(0, 256, (75, 131, 3)).astype(np.uint8)
    src = u8 if src_dtype == "u8" else u8.astype(np.float32) / 255.0
    for size, kw in (((64, 96), {}), ((200, 96), {}),
                     ((64, 96), dict(do_random_scale=True, random_scale_min=1.1,
                                     random_scale_max=1.6))):
        for seed in range(3):
            got = image_ops.resize_and_pad(src, size, rng=np.random.default_rng(seed),
                                           resize_method=method, **kw)
            want = jax_image_ops.resize_and_pad(src, size, rng=np.random.default_rng(seed),
                                                resize_method=method, **kw)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)


def test_native_resize_equals_numpy_resize(monkeypatch):
    """The fused native bilinear (built with -ffp-contract=off) is pixel-
    exact against the port's numpy bilinear."""
    rng = np.random.default_rng(2)
    u8 = rng.integers(0, 256, (75, 131, 3)).astype(np.uint8)
    kw = dict(do_random_scale=True, random_scale_min=1.1, random_scale_max=1.6)
    got = image_ops.resize_and_pad(u8, (64, 96), rng=np.random.default_rng(7), **kw)
    monkeypatch.setattr(_native, "load", lambda: None)
    want = image_ops.resize_and_pad(u8.astype(np.float32) / 255.0, (64, 96),
                                    rng=np.random.default_rng(7), **kw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("allowed", ["all", "brightness,contrast", "hsb", "grayscale"])
def test_augment_matches_jax(allowed):
    img = np.random.default_rng(3).uniform(0, 1, (32, 48, 3)).astype(np.float32)
    for seed in range(6):
        got = image_ops.lightweight_image_augment(
            img, np.random.default_rng(seed), augment_prob=0.9, allowed_transforms=allowed)
        want = jax_image_ops.lightweight_image_augment(
            img, np.random.default_rng(seed), augment_prob=0.9, allowed_transforms=allowed)
        np.testing.assert_array_equal(got, want)


def _same_batch(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    """Two shards from each package's writer (PIL's JPEGs, the port's)."""
    d = tmp_path_factory.mktemp("shards")
    paths = [str(d / "jax-0.tfrecord"), str(d / "port-1.tfrecord")]
    jax_write_shard(paths[0], num_examples=5, num_chunks=4, seed=1, img_hw=(80, 120))
    write_synthetic_shard(paths[1], num_examples=5, num_chunks=4, seed=2, img_hw=(72, 128))
    return paths


@pytest.mark.parametrize("is_training", [True, False], ids=["train", "eval"])
def test_loader_batches_match_jax(shards, is_training):
    kw = dict(batch_size=2, is_training=is_training, num_threads=2, shuffle_buffer=4,
              seed=3, repeat=is_training)
    got = iter(pretrain_loader.PretrainLoader(shards, CONFIG, **kw))
    want = iter(jax_loader.PretrainLoader(shards, CONFIG, **kw))
    n = 0
    for a, b in zip(got, want):
        _same_batch(a, b)
        n += 1
        if n == 4:
            break
    assert n == 4
    assert a["images"].shape == (8, 64, 96, 3)
    got.close()


@pytest.mark.parametrize("is_training,unbatch,start", [
    (True, 1, 3), (True, 1, 7), (True, 2, 5), (False, 1, 3), (False, 1, 6)],
    ids=["train-3", "train-7-past-an-epoch", "train-unbatch2-5", "eval-3", "eval-past-the-end"])
def test_loader_starts_at_a_later_batch_without_parsing(shards, monkeypatch, is_training,
                                                        unbatch, start):
    """batches(start) yields what iterating from the first batch and
    dropping start gives, and parses no record of the batches passed over
    (a record's generator is the spawn of its index in the stream)."""
    config = dict(CONFIG, unbatch_size=unbatch)
    kw = dict(batch_size=2, is_training=is_training, num_threads=2, shuffle_buffer=4,
              seed=3, repeat=is_training)
    want = list(itertools.islice(pretrain_loader.PretrainLoader(shards, config, **kw),
                                 start + 2))[start:]
    parsed = []
    real = pretrain_loader.parse_pretrain_example

    def counting(payload, config, rng, is_training=True):
        parsed.append(rng.bit_generator.seed_seq.spawn_key[0])
        return real(payload, config, rng, is_training)

    monkeypatch.setattr(pretrain_loader, "parse_pretrain_example", counting)
    it = pretrain_loader.PretrainLoader(shards, config, **kw).batches(start)
    got = list(itertools.islice(it, 2))
    it.close()
    assert len(got) == len(want) == (0 if start >= 5 and not is_training else 2)
    for a, b in zip(got, want):
        _same_batch(a, b)
    if got:
        assert min(parsed) >= (start // unbatch) * 2
    else:
        assert parsed == []


def test_skip_collate_draws_what_a_collate_draws(shards):
    payload = next(iter(tfrecord.read_tfrecords(shards[1])))
    for config, is_training in ((CONFIG, True), (CONFIG, False),
                                (dict(CONFIG, unbatch_size=2), True),
                                (dict(CONFIG, image_shuffle_prob=0.0), True)):
        ex = pretrain_loader.parse_pretrain_example(payload, config,
                                                    np.random.default_rng(5), is_training)
        examples = (ex if isinstance(ex, list) else [ex]) * 3
        a, b = np.random.default_rng(6), np.random.default_rng(6)
        pretrain_loader.collate_pretrain_batch(examples[:3], config, a, is_training)
        pretrain_loader.skip_collate(3, config, b, is_training)
        assert a.bit_generator.state == b.bit_generator.state


def test_collate_and_parse_match_jax(shards):
    payload = next(iter(tfrecord.read_tfrecords(shards[1])))
    examples = []
    for mod in (pretrain_loader, jax_loader):
        examples.append(mod.parse_pretrain_example(payload, CONFIG,
                                                   np.random.default_rng(5)))
    _same_batch(*examples)
    batches = [mod.collate_pretrain_batch([examples[0]] * 2, CONFIG,
                                          np.random.default_rng(6))
               for mod in (pretrain_loader, jax_loader)]
    _same_batch(*batches)


def test_device_iterator_keeps_order_content_and_dtypes():
    rng = np.random.default_rng(4)
    host = [{"images": rng.uniform(0, 1, (4, 8, 8, 3)).astype(np.float32),
             "input_ids": rng.integers(0, 100, (2, 2, 5)).astype(np.int32),
             "is_eoc": rng.uniform(size=(2, 2)) < 0.5} for _ in range(5)]
    got = list(pretrain_loader.device_iterator(iter(host), "cpu"))
    assert len(got) == 5
    for g, h in zip(got, host):
        assert g["images"].dtype == torch.bfloat16
        torch.testing.assert_close(g["images"], torch.from_numpy(h["images"]).bfloat16(),
                                   rtol=0, atol=0)
        np.testing.assert_array_equal(g["input_ids"].numpy(), h["input_ids"])
        np.testing.assert_array_equal(g["is_eoc"].numpy(), h["is_eoc"])
    u8 = next(pretrain_loader.device_iterator(iter(host), "cpu", images_u8=True))
    assert u8["images"].dtype == torch.uint8
    np.testing.assert_array_equal(
        u8["images"].numpy(), np.clip(np.round(host[0]["images"] * 255.0), 0, 255))
    f32 = next(pretrain_loader.device_iterator(iter(host), "cpu", images_bf16=False))
    np.testing.assert_array_equal(f32["images"].numpy(), host[0]["images"])


def test_device_iterator_raises_the_workers_error():
    def failing():
        yield {"x": np.zeros(3, np.float32)}
        raise ValueError("boom in the loader")

    it = pretrain_loader.device_iterator(failing(), "cpu")
    assert next(it)["x"].shape == (3,)
    with pytest.raises(ValueError, match="boom in the loader"):
        next(it)


def test_device_iterator_stops_its_worker_when_abandoned():
    def endless():
        i = 0
        while True:
            yield {"i": np.array([i])}
            i += 1

    before = set(threading.enumerate())
    it = pretrain_loader.device_iterator(endless(), "cpu")
    assert [int(next(it)["i"][0]) for _ in range(3)] == [0, 1, 2]
    workers = set(threading.enumerate()) - before
    assert len(workers) == 1
    it.close()                   # stops the worker and waits for it
    assert not any(t.is_alive() for t in workers)


def test_device_iterator_close_warns_of_a_stuck_worker(monkeypatch):
    """A worker stuck in the loader's next() does not hold close() up past
    WORKER_JOIN_S: close() returns and warns."""
    release = threading.Event()

    def stuck():
        yield {"i": np.array([0])}
        release.wait()
        yield {"i": np.array([1])}

    monkeypatch.setattr(pretrain_loader, "WORKER_JOIN_S", 0.2)
    it = pretrain_loader.device_iterator(stuck(), "cpu")
    assert int(next(it)["i"][0]) == 0
    with pytest.warns(RuntimeWarning, match="still runs"):
        it.close()
    release.set()
