"""Small copies of the cells for the CPU tests: every width cut, every
mechanism kept (the LiteResNet stem, the three towers, the masking, the
objectives, dropout, bf16 compute), and a Context on the CPU."""

from __future__ import annotations

import copy

import torch

from benchmark.harness import registry
from benchmark.harness.cell import Context

SEED = 2 ** 31 + 5


def tiny_config(name: str, fp32: bool = False, width: int = 64, layers: int = 2) -> dict:
    c = copy.deepcopy(registry.config(name))
    m = c["model"]
    heads = width // 64 if width >= 256 else width // 16   # heads of 64 at real widths
    if name == "grover-medium":
        m.update(hidden_size=width, num_hidden_layers=layers, num_attention_heads=heads,
                 intermediate_size=2 * width)
        return c
    m.update(hidden_size=width, contrastive_size=width, intermediate_size=4 * width,
             num_attention_heads=heads, num_hidden_layers=layers,
             num_vision_transformer_hidden_layers=layers,
             num_lang_transformer_hidden_layers=layers, resnet_layers=[1, 1, 1])
    c["per_cell"]["pretrain"]["image_size"] = [32, 64]
    c["per_cell"]["zeroshot"]["image_size"] = [32, 32]
    if fp32:
        m.update(use_bfloat16=False, attention_softmax_fp32=True)
        c["optimizer"]["use_bfloat16_adam"] = False
    return c


def tiny_params(workload: str) -> dict:
    p = dict(registry.workload(workload)["params"])
    if "pretrain" in workload:
        p.update(examples=2, chunks=8)
    elif "grover" in workload:
        p.update(batch=2, seq=64)
    else:
        p.update(stories=2)
    return p


def tiny_cell(workload: str, fp32: bool = False, seed: int = SEED, limits=None, **size):
    wl = registry.workload(workload)
    ctx = Context(config=tiny_config(wl["config"], fp32, **size), params=tiny_params(workload),
                  limits=dict(wl["limits"] if limits is None else limits), seed=seed,
                  device=torch.device("cpu"))
    return registry.traffic(wl["traffic"]).Cell(ctx)
