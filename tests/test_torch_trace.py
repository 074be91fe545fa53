"""merlot_tpu_torch.core.trace: the program's spans, on the CPU at tiny
sizes. With no profiler recording a span is one shared null context;
under ``torch.profiler`` the train steps, the zero-shot fn and the
Trainer's loader wait give their span trees, in the profile's events and
in ``trace.recorded()``."""

import json
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from merlot_tpu_torch.core import trace
from merlot_tpu_torch.downstream.sort_story.zero_shot import make_zero_shot_fn
from merlot_tpu_torch.models.config import MerlotConfig
from merlot_tpu_torch.models.grover import GroverConfig, GroverLM
from merlot_tpu_torch.models.merlot import MerlotModel
from merlot_tpu_torch.models.pretrain import MerlotPretrainModel
from merlot_tpu_torch.nn.layers import init_params
from merlot_tpu_torch.tools.grover_train import grover_optimizer, make_grover_loss
from merlot_tpu_torch.train.harness import Trainer
from merlot_tpu_torch.train.optimizer import AdamWConfig, MerlotAdamW
from merlot_tpu_torch.train.train_step import make_loss_train_step, make_train_step

TINY = dict(hidden_size=64, num_attention_heads=4, intermediate_size=128,
            num_hidden_layers=2, num_vision_transformer_hidden_layers=2,
            num_lang_transformer_hidden_layers=2, image_size=(32, 64), resnet_layers=(1, 1, 1),
            num_chunks_in_group=2, contrastive_size=64, use_bfloat16=False,
            hidden_dropout_prob=0.1)
OPT = dict(learning_rate=1e-3, num_train_steps=10, num_warmup_steps=1)
PRETRAIN_TREE = [("step", None), ("step.forward", "step"), ("model.vision", "step.forward"),
                 ("model.vision.stem", "model.vision"), ("model.language", "step.forward"), ("model.masking", "step.forward"),
                 ("model.joint", "step.forward"), ("step.backward", "step"),
                 ("step.update", "step")]


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    trace.clear()
    yield
    trace.clear()
    torch.set_num_threads(n)


def _pretrain_model(cfg=None):
    model = MerlotPretrainModel(cfg or MerlotConfig(**TINY))
    init_params(model, torch.Generator().manual_seed(0))
    return model


def _pretrain_batch(cfg, examples=2, chunks=4, tokens=8, seed=0):
    g = torch.Generator().manual_seed(seed)
    n_img, group = examples * chunks, cfg.num_chunks_in_group
    ids = torch.randint(100, cfg.vocab_size, (examples, chunks, tokens), generator=g)
    ids[..., 5:] = 0
    return {"images": torch.rand((n_img, *cfg.image_size, 3), generator=g),
            "input_ids": ids,
            "shuffled_idx_img": torch.arange(group).repeat(n_img // group),
            "video_src_ids": torch.arange(n_img // group).repeat_interleave(group)
            .reshape(examples, chunks)}


def _traced(fn):
    """(the span trees ``fn`` recorded, the profile's event names). A span is
    a function's record, never a user annotation (which the profiler would
    mirror onto the device as an interval covering its idle gaps)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return trace.recorded(), {e.name for e in prof.events() if not e.is_user_annotation}


def _tree(root):
    return [(r.name, r.parent) for r in root]


def test_no_profiler_no_span(monkeypatch):
    entered = []
    real = trace._record_function
    monkeypatch.setattr(trace, "_record_function", lambda name: entered.append(name) or real(name))
    assert trace.span("step") is trace.span("step.update")
    with trace.span("step"):
        with trace.span("step.forward"):
            pass
    model = _pretrain_model()
    opt = MerlotAdamW(AdamWConfig(**OPT))
    make_train_step(model, opt, device="cpu")(model, opt.init(dict(model.named_parameters())),
                                              _pretrain_batch(model.cfg),
                                              torch.Generator().manual_seed(1))
    assert entered == [] and trace.recorded() == []


def test_pretrain_step_tree():
    model = _pretrain_model()
    opt = MerlotAdamW(AdamWConfig(**OPT))
    state = opt.init(dict(model.named_parameters()))
    step = make_train_step(model, opt, device="cpu")
    batch = _pretrain_batch(model.cfg)
    roots, names = _traced(lambda: step(model, state, batch, torch.Generator().manual_seed(1)))
    assert len(roots) == 1 and _tree(roots[0]) == PRETRAIN_TREE
    assert {n for n, _ in PRETRAIN_TREE} <= names
    by_name = {r.name: r for r in roots[0]}
    assert all(r.host_ms > 0 and r.device_ms is None for r in roots[0])
    parts = sum(by_name[n].host_ms for n in ("step.forward", "step.backward", "step.update"))
    assert parts <= by_name["step"].host_ms
    assert sum(by_name[n].host_ms for n in ("model.vision", "model.language", "model.masking",
                                            "model.joint")) <= by_name["step.forward"].host_ms


def test_grover_loss_step_tree():
    cfg = GroverConfig(vocab_size=503, hidden_size=64, num_hidden_layers=2,
                       num_attention_heads=4, intermediate_size=128,
                       max_position_embeddings=64)
    model = GroverLM(cfg)
    init_params(model, torch.Generator().manual_seed(0))
    opt = grover_optimizer(1e-3, 10, 0)
    state = opt.init(dict(model.named_parameters()))
    step = make_loss_train_step(make_grover_loss(cfg, 1.0), opt, device="cpu")
    ids = torch.randint(1, 503, (2, 17), generator=torch.Generator().manual_seed(2))
    batch = {"input_ids": ids, "is_target": (torch.arange(17) >= 8).int().expand(2, 17)}
    roots, names = _traced(lambda: step(model, state, batch, torch.Generator().manual_seed(3)))
    assert [_tree(r) for r in roots] == [[("step", None), ("step.forward", "step"),
                                          ("step.backward", "step"), ("step.update", "step")]]
    assert {"step", "step.forward", "step.backward", "step.update"} <= names


def test_zero_shot_tree():
    cfg = MerlotConfig(**{**TINY, "num_chunks_in_group": 3}).eval_mode()
    model = MerlotModel(cfg).eval()
    init_params(model, torch.Generator().manual_seed(0))
    fn = make_zero_shot_fn(2, 3)
    g = torch.Generator().manual_seed(4)
    images = torch.rand((2, 3, *cfg.image_size, 3), generator=g)
    ids = torch.randint(100, cfg.vocab_size, (2, 3, 8), generator=g)
    roots, names = _traced(lambda: fn(model, images, ids))
    assert [_tree(r) for r in roots] == [[("step", None), ("model.vision", "step"),
                                          ("model.vision.stem", "model.vision"),
                                          ("model.joint", "step")]]
    assert {"step", "model.vision", "model.joint"} <= names


def test_ring_keeps_the_last_roots():
    with profile(activities=[ProfilerActivity.CPU]):
        for i in range(trace.RING + 6):
            with trace.span(f"root{i}"):
                with trace.span("child"):
                    pass
    roots = trace.recorded()
    assert len(roots) == trace.RING
    assert [r[0].name for r in roots] == [f"root{i}" for i in range(6, trace.RING + 6)]
    assert all(_tree(r)[1:] == [("child", r[0].name)] for r in roots)
    trace.clear()
    assert trace.recorded() == []


def test_trainer_logs_its_wait_on_the_batches(tmp_path):
    model = _pretrain_model()
    trainer = Trainer(model, MerlotAdamW(AdamWConfig(**OPT)), output_dir=str(tmp_path),
                      log_every=2, checkpoint_every=100, device="cpu")
    sleep_s = 0.3

    def slow():
        for i in range(4):
            if i == 1:
                time.sleep(sleep_s)
            yield _pretrain_batch(model.cfg, seed=i)
    trainer.run(trainer.init_state(), slow(), num_steps=4)
    lines = [json.loads(x) for x in open(tmp_path / "train_metrics.jsonl")]
    assert [x["step"] for x in lines] == [2, 4]
    assert lines[0]["perf/data_wait_s"] >= sleep_s
    assert 0 <= lines[1]["perf/data_wait_s"] < sleep_s
    assert all("steps_per_sec" not in x for x in lines)
