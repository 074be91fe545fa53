"""Vision backbone: ViT with an optional weight-standardized LiteResNet stem
(counterpart of merlot_tpu/nn/vit.py).

  * hybrid stem = 3-conv stem (stride 2, then a 2x2 avg-pool) + bottleneck
    groups that downsample by avg-pool, GroupNorm(32, eps 1e-4), weight
    standardization;
  * 2 zero CLS slots prepended (CLS#0 feeds the joint encoder, CLS#1 is
    the contrastive target);
  * a learned [max_nimg, 64, 64, D] grid position table sliced to the grid;
  * patches are LN'd in fp32, then run through the ViT in the compute
    dtype; a 2x2 avg-pool shrinks the grid before the joint encoder.

The stem's GroupNorm backend is ``ops.cuda_groupnorm.BACKEND`` on
forward-only (deterministic) calls and ``TRAIN_BACKEND`` in training, as
the JAX package picks ``pallas_groupnorm.BACKEND``/``TRAIN_BACKEND``.

Images are NHWC [B, H, W, 3] in [0, 1] (float) or uint8.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import torch
from torch import nn

from merlot_tpu_torch.nn.layers import (GroupNorm, LayerNorm, WSConv, _param,
                                        avg_pool_same, avg_pool_valid,
                                        trunc_normal_)
from merlot_tpu_torch.nn.transformer import TransformerEncoder, TransformerHParams
from merlot_tpu_torch.ops import cuda_groupnorm


class PositionEmbedder2D(nn.Module):
    """[max_nimg, 64, 64, D] grid PE + per-image CLS PE, sliced and flattened
    to [num_img * (num_cls_emb + num_h*num_w), D] fp32."""

    def __init__(self, embedding_size: int, max_nimg: int = 1,
                 max_position_embeddings: int = 64, num_cls_emb: int = 1,
                 initializer_range: float = 0.02, device=None):
        super().__init__()
        m = max_position_embeddings
        self.embedding_size = embedding_size
        self.num_cls_emb = num_cls_emb
        self.initializer_range = initializer_range
        self.pos_embs = _param(max_nimg, m, m, embedding_size, device=device)
        self.cls_emb = (_param(max_nimg, num_cls_emb, embedding_size, device=device)
                        if num_cls_emb > 0 else None)

    def init_weights(self, gen):
        trunc_normal_(self.pos_embs, self.initializer_range, gen)
        if self.cls_emb is not None:
            trunc_normal_(self.cls_emb, self.initializer_range, gen)

    def forward(self, num_h: int, num_w: int, num_img: int = 1) -> torch.Tensor:
        d = self.embedding_size
        grid = self.pos_embs[:num_img, :num_h, :num_w].reshape(
            num_img, num_h * num_w, d)
        if self.cls_emb is not None:
            grid = torch.cat([self.cls_emb[:num_img], grid], dim=1)
        return grid.reshape(num_img * (self.num_cls_emb + num_h * num_w), d)


class BottleneckBlock(nn.Module):
    """1x1 -> 3x3 -> (avgpool if downsampling) -> 1x1, GN+relu, avg-pool
    shortcut; ``gn_backend`` is every GroupNorm's backend (None: the
    module default)."""

    def __init__(self, in_channels: int, filters: int, strides: int = 1,
                 use_projection: bool = False, dtype=torch.bfloat16, device=None):
        super().__init__()
        self.strides = strides
        kw = dict(dtype=dtype, device=device)
        self.use_projection = use_projection
        if use_projection:
            self.proj_conv = WSConv(in_channels, 4 * filters, 1, **kw)
            self.proj_gn = GroupNorm(4 * filters, device=device)
        self.conv1 = WSConv(in_channels, filters, 1, **kw)
        self.gn1 = GroupNorm(filters, device=device)
        self.conv2 = WSConv(filters, filters, 3, **kw)
        self.gn2 = GroupNorm(filters, device=device)
        self.conv3 = WSConv(filters, 4 * filters, 1, **kw)
        self.gn3 = GroupNorm(4 * filters, device=device)

    def forward(self, x: torch.Tensor, gn_backend: Optional[str] = None) -> torch.Tensor:
        gn = dict(backend=gn_backend)
        shortcut = x
        if self.use_projection:
            s = (avg_pool_same(x, self.strides, self.strides)
                 if self.strides > 1 else x)
            shortcut = self.proj_gn(self.proj_conv(s), **gn)
        y = self.gn1(self.conv1(x), relu=True, **gn)
        y = self.gn2(self.conv2(y), relu=True, **gn)
        if self.strides > 1:
            y = avg_pool_same(y, self.strides, self.strides)
        return self.gn3(self.conv3(y), residual=shortcut, relu=True, **gn)


class LiteResNet(nn.Module):
    """The reference's "lite resnet50": 3-conv stem + N bottleneck groups.
    Total downsampling is 4 * 2^(len(layers)-1): /16 for [3, 4, 9].
    ``gn_backend`` is every GroupNorm's backend (None: the module
    default)."""

    def __init__(self, layers: Sequence[int] = (3, 4, 6, 3), width: int = 64,
                 dtype=torch.bfloat16, device=None):
        super().__init__()
        w = width
        kw = dict(dtype=dtype, device=device)
        self.stem_conv0 = WSConv(3, w // 2, 3, strides=2, **kw)
        self.stem_gn0 = GroupNorm(w // 2, device=device)
        self.stem_conv1 = WSConv(w // 2, w // 2, 3, **kw)
        self.stem_gn1 = GroupNorm(w // 2, device=device)
        self.stem_conv2 = WSConv(w // 2, w, 3, **kw)
        self.stem_gn2 = GroupNorm(w, device=device)
        self.block_names = []
        cin = w
        for i, blocks in enumerate(layers):
            filters = w * (2 ** i)
            for b in range(blocks):
                name = f"group{i + 1}_block{b}"
                self.add_module(name, BottleneckBlock(
                    cin, filters, strides=(1 if i == 0 else 2) if b == 0 else 1,
                    use_projection=b == 0, **kw))
                self.block_names.append(name)
                cin = 4 * filters
        self.out_channels = cin

    def forward(self, x: torch.Tensor, gn_backend: Optional[str] = None) -> torch.Tensor:
        gn = dict(backend=gn_backend)
        x = self.stem_gn0(self.stem_conv0(x), relu=True, **gn)
        x = self.stem_gn1(self.stem_conv1(x), relu=True, **gn)
        x = self.stem_gn2(self.stem_conv2(x), relu=True, **gn)
        x = avg_pool_same(x, 2, 2)
        for name in self.block_names:
            x = getattr(self, name)(x, gn_backend)
        return x


class VisionBackbone(nn.Module):
    """ViT over one frame; returns CLS states and the pooled grid sequence:
      cls [B*, num_cls_emb, H] and seq [B*, num_h*num_w, H] (compute dtype),
      num_h, num_w (ints, after pooling)."""

    def __init__(self, patch_size: int = 16, hidden_size: int = 768,
                 num_cls_emb: int = 2, resnet_layers: Sequence[int] = (),
                 spatial_pool_size: int = 2,
                 vit_hp: TransformerHParams = TransformerHParams(),
                 initializer_range: float = 0.02, dtype=torch.bfloat16,
                 device=None):
        super().__init__()
        self.patch_size = patch_size
        self.hidden_size = hidden_size
        self.num_cls_emb = num_cls_emb
        self.spatial_pool_size = spatial_pool_size
        self.dtype = dtype
        self.has_resnet = len(resnet_layers) > 0
        if not self.has_resnet:
            self.patch_conv = WSConv(3, hidden_size, patch_size, strides=patch_size,
                                     weight_standardization=False, use_bias=True,
                                     padding="VALID", dtype=dtype, device=device)
        else:
            if patch_size != 16:
                raise ValueError("the hybrid ResNet stem downsamples by exactly 16")
            self.resnet = LiteResNet(tuple(resnet_layers), width=64, dtype=dtype,
                                     device=device)
            self.post_resnet_proj = WSConv(
                self.resnet.out_channels, hidden_size, 1,
                weight_standardization=False, use_bias=True, dtype=dtype,
                device=device)
        self.pos_emb2d = PositionEmbedder2D(hidden_size, max_nimg=1,
                                            num_cls_emb=num_cls_emb,
                                            initializer_range=initializer_range,
                                            device=device)
        self.patches_pre_ln = LayerNorm(hidden_size, device=device)
        self.encoder = TransformerEncoder(vit_hp, device=device)

    def forward(self, image: torch.Tensor, *, attn_backend: str = "auto",
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> Dict[str, Any]:
        p = self.patch_size
        b, h0, w0, _ = image.shape
        if h0 % p or w0 % p:
            raise ValueError(f"image {h0}x{w0} not divisible by patch {p}")
        if image.dtype == torch.uint8:
            # pixels quantized to 1/255 steps; dequantize in fp32
            image = image.float() * (1.0 / 255.0)
        img_norm = image.to(self.dtype) - 0.5
        if self.has_resnet:
            gn = (cuda_groupnorm.BACKEND if deterministic
                  else cuda_groupnorm.TRAIN_BACKEND)
            x = self.post_resnet_proj(self.resnet(img_norm, gn_backend=gn))
        else:
            x = self.patch_conv(img_norm)

        h1, w1 = h0 // p, w0 // p
        d = self.hidden_size
        x = x.reshape(b, h1 * w1, d).float()
        x = torch.cat([x.new_zeros(b, self.num_cls_emb, d), x], dim=1)
        x = self.patches_pre_ln(x + self.pos_emb2d(h1, w1, 1)[None])

        hidden = self.encoder(x.to(self.dtype), None, attn_backend=attn_backend,
                              deterministic=deterministic,
                              generator=generator)["hidden_state"]
        cls = hidden[:, :self.num_cls_emb]
        seq = hidden[:, self.num_cls_emb:]
        sp = self.spatial_pool_size
        if sp > 1:
            grid = avg_pool_valid(seq.reshape(b, h1, w1, d), sp, sp)
            h2, w2 = h1 // sp, w1 // sp
            seq = grid.reshape(b, h2 * w2, d)
        else:
            h2, w2 = h1, w1
        return {"cls": cls, "seq": seq, "num_h": h2, "num_w": w2}
