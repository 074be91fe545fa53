"""The CLI pretraining cell (``traffic/pretrain_cli.py``) at a CPU size.

The reference's reading of the shards (``reference/pretrain_data.py``)
gives the batches the port's loader gives, from the same files and seed,
over every random choice of the pretraining recipe; the cell's run (set-up
through ``train/pretrain.py``'s loop, a window, the release, the check)
comes out correct on a sound program, and not correct when the loader
leaves out the augmentation or the frame shuffle; its shards are removed
after the check.

The size: the tiny MERLOT of ``tiny.py`` (width 64, two layers a tower,
32 x 64 images, 2 examples of 8 segments), frames of 72 x 128 in 2 shards,
run in float32, where the CLI's steps and the reference's are the same
arithmetic (as ``test_bench_reference.py`` holds the pretrain cell).
The images the two readings give agree to float32 rounding (1e-5: the
port's bilinear resize works on the bytes, the reference's on their
float32 values); every id and index is equal.
"""

import copy
import glob
import time

import numpy as np
import pytest
import torch

from benchmark.calibrate import seed_readings
from benchmark.harness import registry
from benchmark.harness.cell import Context
from benchmark.harness.measure import run_cell
from benchmark.reference import pretrain_data
from benchmark.tests.tiny import SEED, tiny_config

WORKLOAD = "merlot-base.pretrain-cli"
BENCH = registry.benchmark()


@pytest.fixture(autouse=True, scope="module")
def four_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("buffer,shards,sizes", [(256, 3, (3, 2, 4)), (5, 2, (4, 4)),
                                                 (0, 1, (3,))])
def test_reference_reads_the_loaders_batches(tmp_path, buffer, shards, sizes):
    from merlot_tpu_torch.data.make_synthetic_tfrecord import write_synthetic_shard
    from merlot_tpu_torch.data.pretrain_loader import PretrainLoader
    for s, n in enumerate(sizes):
        write_synthetic_shard(str(tmp_path / f"train-{s}.tfrecord"), n, 8, seed=s,
                              img_hw=(72, 128))
    files = sorted(glob.glob(str(tmp_path / "*.tfrecord")))
    cfg = dict(registry.workload(WORKLOAD)["params"]["data"], num_chunks=8,
               chunk_text_len=32, image_size=[32, 64], num_chunks_in_group=4,
               image_shuffle_prob=0.4)
    loader = PretrainLoader(files, cfg, batch_size=2, shuffle_buffer=buffer, num_threads=2)
    it = loader.batches(0)
    want = [next(it) for _ in range(4)]
    it.close()
    got = pretrain_data.batches(files, cfg, 2, 4, shuffle_buffer=buffer)
    for g, w in zip(got, want):
        for k in ("input_ids", "video_src_ids", "shuffled_idx_img"):
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
        np.testing.assert_allclose(g["images"], w["images"], rtol=0, atol=1e-5)


def tiny_cell(fp32=True):
    wl = registry.workload(WORKLOAD)
    params = copy.deepcopy(wl["params"])
    params.update(examples=2, chunks=8, frame=[72, 128], shards=2, check_steps=2)
    ctx = Context(config=tiny_config(wl["config"], fp32), params=params,
                  limits=dict(wl["limits"]), seed=SEED, device=torch.device("cpu"))
    return registry.traffic(wl["traffic"]).Cell(ctx)


def run(cell):
    return run_cell(cell, registry.workload(WORKLOAD), registry.cell_metrics(BENCH, WORKLOAD),
                    seconds=0.3, trace=False, t_start=time.perf_counter())


def test_sound_run_is_correct():
    cell = tiny_cell()
    res = run(cell)
    assert res["correct"], res["checks"]
    assert res["checks"]["batch_gap"]["value"] <= 1e-5
    assert set(res["metrics"]) == {"segments_per_s", "setup_s"}
    assert not cell.dir.exists()


def test_the_cli_steps_are_the_references_in_float32():
    # the same arithmetic on the same batches, weights and generators
    row = seed_readings(tiny_cell(), 1, controls=False)["program"]
    assert row["loss_gap"] <= 1e-6, row
    assert row["grad_gap"] <= 1e-5, row
    assert row["change_gap"] <= 1e-3, row


def test_bf16_images_are_rounded_once():
    cell = tiny_cell(fp32=False)
    cell.setup()
    cell.release()
    gap = cell.batch_gap()
    assert 0.0 < gap <= 2 ** -9, gap        # half an ulp of bf16 at 1


def test_augmentation_left_out(monkeypatch):
    from merlot_tpu_torch.data import image_ops
    monkeypatch.setattr(image_ops, "lightweight_image_augment", lambda img, rng, **kw: img)
    res = run(tiny_cell())
    assert not res["correct"], res["checks"]
    assert res["checks"]["batch_gap"]["value"] > 0.01


def test_frame_shuffle_left_out(monkeypatch):
    from merlot_tpu_torch.data import pretrain_loader
    monkeypatch.setattr(pretrain_loader, "sample_shuffled_idx",
                        lambda b, n, g, *a, **kw: np.tile(np.arange(g, dtype=np.int32), b * n // g))
    res = run(tiny_cell())
    assert not res["correct"], res["checks"]
