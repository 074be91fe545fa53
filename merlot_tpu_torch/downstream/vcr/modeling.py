"""VCR finetuning model: MerlotModel + answer/rationale classifier heads
(counterpart of merlot_tpu/downstream/vcr/modeling.py).

  * MerlotModel runs with num_texts=4 (each image's features tiled across
    its 4 choices) and no masking;
  * training: the token-0 hidden states reshape to [b, 2 (answer |
    rationale), 4, H]; one 2-layer head per mode (dense H/2 + gelu, then
    dense 1 with its bias at the prior -log((1-pi)/pi), pi = 0.25), dropout
    before each dense;
  * evaluation: one mode's head ('answer_cls' or 'rationale_cls', the
    training heads);
  * the loss: softmax cross-entropy over the 4 choices, summed and divided
    by the image batch.

Submodules are named ``merlot``, ``answer_cls`` and ``rationale_cls``, so
the flax paths are the JAX model's and a pretrain checkpoint (rooted at
``merlot/``) warm-starts it. The attention backend is the device's: the
kernels on a card (K1, and K2 where a gradient is taken), the plain
composition on the CPU (``ops.attention.training_backend`` /
``inference_backend``). The JAX package trains with XLA's attention, the
same function.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from merlot_tpu_torch.models.config import MerlotConfig
from merlot_tpu_torch.models.merlot import MerlotModel
from merlot_tpu_torch.nn.layers import DenseTN, dropout
from merlot_tpu_torch.ops.activations import gelu
from merlot_tpu_torch.ops.attention import inference_backend, training_backend
from merlot_tpu_torch.parallel.mesh import Mesh

NUM_CHOICES = 4


class _PriorDense(DenseTN):
    """DenseTN whose bias starts at a constant (the class prior)."""

    def __init__(self, *args, bias_value: float, **kwargs):
        super().__init__(*args, **kwargs)
        self.bias_value = bias_value

    def init_weights(self, gen):
        super().init_weights(gen)
        with torch.no_grad():
            self.bias.fill_(self.bias_value)


class VCRClsHead(nn.Module):
    """dropout, dense(H/2) + gelu, dropout, dense(1) with the prior bias;
    fp32."""

    def __init__(self, hidden_size: int, initializer_range: float = 0.02,
                 dropout_prob: float = 0.1, bias_pi: float = 0.25, device=None):
        super().__init__()
        self.dropout_prob = dropout_prob
        kw = dict(dtype=torch.float32, initializer_range=initializer_range, device=device)
        self.mlp0 = DenseTN(hidden_size, hidden_size // 2, **kw)
        self.mlp1 = _PriorDense(hidden_size // 2, 1,
                                bias_value=-math.log((1.0 - bias_pi) / bias_pi), **kw)

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        drop = dict(deterministic=deterministic, generator=generator)
        x = dropout(x, self.dropout_prob, **drop)
        x = gelu(self.mlp0(x))
        x = dropout(x, self.dropout_prob, **drop)
        return self.mlp1(x)


class VCRModel(nn.Module):
    """Joint answer+rationale training and single-mode evaluation on top
    of MerlotModel."""

    def __init__(self, cfg: MerlotConfig, device=None):
        super().__init__()
        if cfg.num_texts != NUM_CHOICES:
            raise ValueError(f"VCR needs num_texts={NUM_CHOICES}, got {cfg.num_texts}")
        self.cfg = cfg
        self.merlot = MerlotModel(cfg, device=device)
        head = dict(initializer_range=cfg.initializer_range,
                    dropout_prob=cfg.hidden_dropout_prob, device=device)
        self.answer_cls = VCRClsHead(cfg.hidden_size, **head)
        self.rationale_cls = VCRClsHead(cfg.hidden_size, **head)

    def forward(self, images: torch.Tensor, lm_input: torch.Tensor, *,
                mode: Optional[str] = None, deterministic: bool = True,
                attn_backend: Optional[str] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Logits over the 4 choices.

        Training (mode None): images [b*2, h, w, 3], lm_input [b*2*4, 184]
        (answer and rationale interleaved per example) -> logits [b*2, 4]:
        each example's answer row, then its rationale row.
        Evaluation (mode 'answer' | 'rationale'): images [b, h, w, 3],
        lm_input [b, 4, 184] or [b*4, 184] -> logits [b, 4].
        ``attn_backend`` defaults to the device's training backend when
        not ``deterministic``, else its inference backend. ``generator``
        draws the dropout masks.
        """
        if lm_input.dim() == 3:
            lm_input = lm_input.reshape(-1, lm_input.shape[-1])
        if attn_backend is None:
            pick = inference_backend if deterministic else training_backend
            attn_backend = pick(images.device)
        drop = dict(deterministic=deterministic, generator=generator)
        fwd = self.merlot(images, lm_input, mask_input=False,
                          attn_backend=attn_backend, **drop)
        h0 = fwd["encoder_hidden_states"]["lang"][:, 0]        # [n_text, H] fp32
        img_batch = images.shape[0]

        if mode is None:
            per_ex = h0.reshape(img_batch // 2, 2, NUM_CHOICES, -1)
            ans = self.answer_cls(per_ex[:, 0].reshape(-1, h0.shape[-1]), **drop)
            rat = self.rationale_cls(per_ex[:, 1].reshape(-1, h0.shape[-1]), **drop)
            return torch.cat([ans.reshape(img_batch // 2, NUM_CHOICES),
                              rat.reshape(img_batch // 2, NUM_CHOICES)], dim=1
                             ).reshape(img_batch, NUM_CHOICES)
        if mode not in ("answer", "rationale"):
            raise ValueError(f"bad mode={mode}")
        head = self.answer_cls if mode == "answer" else self.rationale_cls
        return head(h0, **drop).reshape(img_batch, NUM_CHOICES)


def vcr_loss_and_metrics(logits: torch.Tensor, targets: torch.Tensor,
                         mesh: Optional[Mesh] = None
                         ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Softmax cross-entropy over the 4 choices (the sum over the batch
    divided by its size) and the accuracy. With ``mesh`` the batch is this
    rank's rows of the global batch (equal on every rank) and the loss and
    accuracy are this rank's shares of the global ones: the sum over the
    ranks' rows divided by the global size."""
    one_hot = F.one_hot(targets.long(), NUM_CHOICES).to(logits.dtype)
    per_ex = -(F.log_softmax(logits, dim=-1) * one_hot).sum(-1)
    ranks = 1 if mesh is None else mesh.data
    loss = per_ex.sum() / (logits.shape[0] * ranks)
    acc = (logits.argmax(-1) == targets).float().mean()
    if mesh is not None:
        acc = acc * (1.0 / ranks)
    return loss, {"loss": loss, "accuracy": acc}
