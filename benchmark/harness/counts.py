"""Operations and bytes from shapes, and the card's published peaks.

Copied from the port's ``chip_smoke.py`` (``bound``, ``attn_work``) so
that the yardstick stays fixed, with the model-level counts of the
cells' steps beside them. A count is the work the algorithm needs: each
input byte read once, each output byte written once, no recompute.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, Optional, Sequence, Tuple

# NVIDIA's H100 SXM data sheet, dense rates at the full 700 W
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12     # float32 outside the tensor cores
PEAK_HBM_BYTES = 3.35e12


def peak_flops(dtype: str) -> float:
    return PEAK_BF16_FLOPS if dtype == "bf16" else PEAK_FP32_FLOPS


def bound(flops: float, nbytes: float, peak: float) -> Tuple[float, str]:
    """(least seconds the card could take, what bounds it): the larger of
    the operations over ``peak`` and the bytes over the memory's rate."""
    t_ops, t_bytes = flops / peak, nbytes / PEAK_HBM_BYTES
    return max(t_ops, t_bytes), "operations" if t_ops > t_bytes else "bytes"


def attn_work(b: int, sq: int, sk: int, heads: int, d: int, *, masked: bool,
              colsum: bool, backward: bool, elem: int, pairs: Optional[int] = None
              ) -> Tuple[float, float]:
    """(flops, bytes) of one attention call, Sq queries over Sk keys.
    Forward: S = QK^T and ctx = PV; backward: S again, dV, dP, dQ, dK.
    ``pairs``: the (query, key) pairs the mask lets through, summed over
    the batch, where the rest is known to be 0 (a causal mask); all of
    b*sq*sk by default. Bytes: q, k, v (and dO, dQ, dK, dV) once, ctx
    once, the fp32 mask once, the fp32 colsum (or its cotangent) once."""
    pairs = b * sq * sk if pairs is None else pairs
    flops = 2 * (5 if backward else 2) * heads * pairs * d
    q_side, k_side = b * sq * heads * d * elem, b * sk * heads * d * elem
    nbytes = (3 * q_side + 4 * k_side) if backward else (2 * q_side + 2 * k_side)
    nbytes += 4 * b * sq * sk if masked else 0
    nbytes += 4 * b * sk if colsum else 0
    return flops, nbytes


def attention_bound_s(calls: Iterable[Dict[str, Any]], backward: bool) -> float:
    """Summed bound of recorded K1 (K2 with ``backward``) calls: dicts of
    b, sq, sk, heads, d, elem, masked, colsum and pairs."""
    total = 0.0
    for c in calls:
        flops, nbytes = attn_work(c["b"], c["sq"], c["sk"], c["heads"], c["d"],
                                  masked=c["masked"], colsum=c["colsum"], backward=backward,
                                  elem=c["elem"], pairs=c.get("pairs"))
        total += bound(flops, nbytes, PEAK_BF16_FLOPS if c["elem"] == 2 else PEAK_FP32_FLOPS)[0]
    return total


# ---------------------------------------------------------------------------
# whole-step model operations (forward; a training step is 3x: the backward
# takes two products per forward product)


def dense(tokens: float, n_in: int, n_out: int) -> float:
    return 2.0 * tokens * n_in * n_out


def encoder_flops(rows: int, seq: int, hidden: int, inter: int, layers: int,
                  pairs_per_row: Optional[float] = None) -> float:
    """A pre-LN encoder stack: q, k, v, out and the two MLP products per
    token, and QK^T and PV over ``pairs_per_row`` (seq^2 by default)."""
    tokens = rows * seq
    pairs = rows * (seq * seq if pairs_per_row is None else pairs_per_row)
    per_layer = dense(tokens, hidden, 4 * hidden) + dense(tokens, hidden, 2 * inter)
    return layers * (per_layer + 4.0 * pairs * hidden)


def conv(images: int, h_out: int, w_out: int, cin: int, cout: int, k: int) -> float:
    return 2.0 * images * h_out * w_out * cin * cout * k * k


def resnet_flops(images: int, h: int, w: int, layers: Sequence[int], width: int = 64) -> float:
    """The LiteResNet stem (three 3x3 convs, the first of stride 2, then a
    2x2 pool) and its bottleneck groups (the first block of each group
    projects; groups after the first halve the grid)."""
    h2, w2 = -(-h // 2), -(-w // 2)
    total = conv(images, h2, w2, 3, width // 2, 3) + conv(images, h2, w2, width // 2, width // 2, 3)
    total += conv(images, h2, w2, width // 2, width, 3)
    hh, ww, cin = -(-h2 // 2), -(-w2 // 2), width
    for i, blocks in enumerate(layers):
        f = width * 2 ** i
        for b in range(blocks):
            stride = (1 if i == 0 else 2) if b == 0 else 1
            ho, wo = -(-hh // stride), -(-ww // stride)
            if b == 0:
                total += conv(images, ho, wo, cin, 4 * f, 1)
            total += conv(images, hh, ww, cin, f, 1) + conv(images, hh, ww, f, f, 3)
            total += conv(images, ho, wo, f, 4 * f, 1)
            hh, ww, cin = ho, wo, 4 * f
    return total


def vision_flops(m: Dict[str, Any], images: int, image_size: Sequence[int]) -> float:
    """The ViT over ``images`` frames: the ResNet stem and its 1x1
    projection, then the encoder over the patch grid and the CLS tokens."""
    h, w = image_size
    p, hid = m["patch_size"], m["hidden_size"]
    gh, gw = h // p, w // p
    total = resnet_flops(images, h, w, m["resnet_layers"])
    total += dense(images * gh * gw, 64 * 2 ** (len(m["resnet_layers"]) + 1), hid)
    seq = gh * gw + m.get("num_cls_emb", 2)
    layers = m.get("num_vision_transformer_hidden_layers") or m["num_hidden_layers"]
    return total + encoder_flops(images, seq, hid, m["intermediate_size"], layers)


def merlot_forward_flops(m: Dict[str, Any], *, examples: int, chunks: int, tokens: int,
                         image_size: Sequence[int], group: int, pretrain: bool) -> float:
    """MERLOT's forward over ``examples`` x ``chunks`` frame+caption
    segments: the ViT per frame, with ``pretrain`` the language-only tower
    over each example's captions and the three objectives' heads, then the
    joint tower over groups of ``group`` segments."""
    hid, inter, L = m["hidden_size"], m["intermediate_size"], m["num_hidden_layers"]
    sp = m["spatial_pool_size"]
    gh, gw = image_size[0] // m["patch_size"] // sp, image_size[1] // m["patch_size"] // sp
    images = examples * chunks
    total = vision_flops(m, images, image_size)
    rows = examples * chunks // group
    seq = group * (gh * gw + 1) + group * tokens
    total += encoder_flops(rows, seq, hid, inter, L)
    heads = dense(rows * group * group, 2 * hid, hid) + dense(rows * group * group, hid, 4)
    if pretrain:
        total += encoder_flops(examples, chunks * tokens,
                               hid, inter, m["num_lang_transformer_hidden_layers"])
        masked = rows * int(group * tokens * m["masking_rate"])
        total += dense(masked, hid, m["vocab_size"])
        if m.get("do_projection"):
            total += dense(masked, hid, hid) + 2 * dense(images, hid, hid)
        total += 2 * dense(images, hid, m.get("contrastive_size") or hid)
        total += 2 * heads
    else:
        total += 2 * heads
    return total


def grover_forward_flops(m: Dict[str, Any], batch: int, seq: int) -> float:
    """Grover's forward at [batch, seq]: causal attention over the
    seq*(seq+1)/2 pairs it needs, and the tied LM head over every token."""
    hid = m["hidden_size"]
    total = encoder_flops(batch, seq, hid, m["intermediate_size"], m["num_hidden_layers"],
                          pairs_per_row=seq * (seq + 1) / 2)
    return total + dense(batch * seq, hid, m["vocab_size"])
