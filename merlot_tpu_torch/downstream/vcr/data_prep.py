"""VCR offline data preparation: grounding overlays and tagged
tokenization (counterpart of merlot_tpu/downstream/vcr/data_prep.py).

  * An object that the question, an answer or a rationale refers to is
    grounded by drawing a translucent box or segmentation polygon onto the
    pixels (opacity 0.15, outline width 7): each person mentioned gets its
    own color of the Detectron colormap, every other object the last one
    (reference downstream/vcr/data/draw_bbox.py, draw_segms.py).
  * Q/A/R token lists hold inline object references ([2] = object 2);
    persons are renamed GENDER_NEUTRAL_NAMES[idx % 50], a reference to
    several objects is joined with "and", and every BPE token carries the
    tag of its object (index + 1, 0 for none) (reference
    downstream/vcr/data/prepare_data.py:234-349).
  * the tfrecord schema: per mode (answer/rationale) and per overlay
    (bbox/segm) an image, then ctx/ctx_tags, the 4 choices and their tags,
    and the labels.

Given the same inputs, the drawn pixels, the tokenizer's ids and tags and
the Example bytes are the JAX package's. PIL is imported only inside
``draw_grounding`` and ``prepare_vcr_shard``, sacremoses only inside
``VCRTokenizer``: no loader, model or CLI of this package needs either.
The colormap table is Detectron's public visualization palette (data).
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import re
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np

from merlot_tpu_torch.core.tokenizer import get_tokenizer
from merlot_tpu_torch.data.tfrecord import TFRecordWriter, encode_example

# Detectron's public visualization colormap (data table, not code)
COLOR_LIST = np.array([
    [255, 0, 0], [0, 255, 0], [236, 176, 31], [0, 0, 255], [255, 0, 255],
    [170, 0, 255], [255, 255, 0], [170, 84, 0], [84, 84, 0], [255, 127, 0],
    [76, 189, 237], [170, 0, 127], [125, 46, 141], [190, 190, 0],
    [161, 19, 46], [0, 170, 127], [255, 170, 127], [0, 84, 127],
    [255, 84, 127], [170, 170, 255], [170, 170, 127], [84, 0, 0],
    [0, 170, 0], [0, 255, 255], [255, 170, 255], [84, 0, 127],
    [255, 255, 127], [170, 0, 0], [84, 255, 127], [0, 0, 127],
    [170, 84, 127], [170, 84, 255], [170, 170, 0], [216, 82, 24],
    [0, 84, 0], [84, 0, 255], [255, 0, 127], [127, 0, 0], [170, 255, 127],
    [170, 255, 255], [0, 127, 0], [0, 0, 170], [84, 170, 127],
    [0, 113, 188], [118, 171, 47], [84, 84, 127], [0, 42, 0],
    [84, 84, 255], [84, 170, 0], [84, 170, 255], [170, 255, 0],
    [0, 0, 212], [0, 212, 0], [0, 0, 84], [0, 84, 255], [145, 145, 145],
])

GENDER_NEUTRAL_NAMES = [
    'Casey', 'Riley', 'Jessie', 'Jackie', 'Avery', 'Jaime', 'Peyton',
    'Kerry', 'Jody', 'Kendall', 'Skyler', 'Frankie', 'Pat', 'Quinn',
    'Morgan', 'Finley', 'Harley', 'Robbie', 'Sidney', 'Tommie', 'Ashley',
    'Carter', 'Adrian', 'Clarke', 'Logan', 'Mickey', 'Nicky', 'Parker',
    'Tyler', 'Reese', 'Charlie', 'Austin', 'Denver', 'Emerson', 'Tatum',
    'Dallas', 'Haven', 'Jordan', 'Robin', 'Rory', 'Bellamy', 'Salem',
    'Sutton', 'Gray', 'Shae', 'Kyle', 'Alex', 'Ryan', 'Cameron', 'Dakota']

TRANSPARENCY = 0.15
OPACITY = int(255 * TRANSPARENCY)
OUTLINE_WIDTH = 7


# ----------------------------------------------------------------------
# overlay drawing
# ----------------------------------------------------------------------
def collect_mentions(item: Dict[str, Any], mode: str) -> Tuple[List[int], List[int]]:
    """(person mention ids, other object ids) referenced by the Q/A(/R)."""
    mentions: List[int] = []
    objects: List[int] = []
    streams = [item["question"]] + list(item["answer_choices"])
    if mode == "rationale":
        streams += list(item["rationale_choices"])
    for stream in streams:
        for word in stream:
            if isinstance(word, list):
                mentions.extend(w for w in word if item["objects"][w] == "person")
                objects.extend(w for w in word if item["objects"][w] != "person")
    return sorted(set(mentions)), sorted(set(objects))


def draw_grounding(image, shapes: Sequence, mentions: Sequence[int],
                   objects: Sequence[int], kind: str = "bbox"):
    """Draw translucent fills + solid outlines for referenced objects.

    shapes: metadata['boxes'] ([x1,y1,x2,y2,score]) or metadata['segms']
    (list of polygons per object). Returns an RGB PIL image.
    """
    from PIL import Image, ImageDraw
    image = image.convert("RGBA")
    for i, shape in enumerate(shapes):
        if i in mentions:
            color = tuple(int(c) for c in COLOR_LIST[:-1][i % (len(COLOR_LIST) - 1)])
        elif i in objects:
            color = tuple(int(c) for c in COLOR_LIST[-1])
        else:
            continue

        overlay = Image.new("RGBA", image.size, color + (0,))
        odraw = ImageDraw.Draw(overlay)
        if kind == "bbox":
            x1, y1, x2, y2 = (int(v) for v in shape[:4])
            poly = [(x1, y1), (x2, y1), (x2, y2), (x1, y2), (x1, y1)]
            odraw.polygon(poly, fill=color + (OPACITY,))
            ImageDraw.Draw(image).line(poly, fill=color, width=OUTLINE_WIDTH)
        else:
            polys = [tuple(tuple(p) for p in part) for part in shape]
            for poly in polys:
                if len(poly) >= 2:
                    odraw.polygon(poly, fill=color + (OPACITY,))
            idraw = ImageDraw.Draw(image)
            for poly in polys:
                idraw.line(poly + (poly[0],), fill=color, width=OUTLINE_WIDTH)
        image = Image.alpha_composite(image, overlay)
    return image.convert("RGB")


# ----------------------------------------------------------------------
# tagged tokenization
# ----------------------------------------------------------------------
class VCRTokenizer:
    """Tokenize VCR token streams, grounding [obj] references.

    Object references become names (persons) or class words, each BPE token
    tagged with object_index+1 (0 = no object). Multi-object refs are joined
    with "and". Detokenization uses Moses (same as the reference).
    """

    def __init__(self):
        try:
            from sacremoses import MosesDetokenizer
        except ImportError as e:
            raise ImportError("VCRTokenizer needs the sacremoses package "
                              "(Moses detokenization, as the reference)") from e
        self.tok = get_tokenizer()
        self.detok = MosesDetokenizer(lang="en")
        self.obj_pat = re.compile(r"OBJ-[0-9]+")

    def __call__(self, text: Sequence, objects: Sequence[str],
                 pad_tag: int = 0) -> Tuple[List[int], List[int]]:
        moses_tokens, obj_lists = [], []
        for w in text:
            if isinstance(w, list):
                moses_tokens.append(f"OBJ-{len(obj_lists)}")
                obj_lists.append(w)
            else:
                moses_tokens.append(w)
        sentence = self.detok.detokenize(moses_tokens)

        ids: List[int] = []
        tags: List[int] = []

        def emit(text_piece: str, tag: int):
            piece_ids = self.tok.encode(text_piece)
            ids.extend(piece_ids)
            tags.extend([tag] * len(piece_ids))

        for i, word in enumerate(sentence.split()):
            m = self.obj_pat.search(word)
            if not m:
                emit(f" {word}" if i else word, pad_tag)
                continue
            start, end = m.span()
            pre, post = word[:start], word[end:]
            if pre:
                emit(f" {pre}" if i else pre, pad_tag)
            obj_list = obj_lists[int(word[start:end].split("-")[-1])]
            for j, obj_id in enumerate(obj_list):
                if len(obj_list) > 1 and j + 1 == len(obj_list):
                    emit(" and", pad_tag)
                obj = objects[obj_id]
                if obj == "person":
                    obj = GENDER_NEUTRAL_NAMES[obj_id % len(GENDER_NEUTRAL_NAMES)]
                word_out = obj if start else (f" {obj}" if i + j else obj.capitalize())
                emit(word_out, obj_id + 1)
            if post:
                emit(post, pad_tag)
        return ids, tags


# ----------------------------------------------------------------------
# example building / shard writing
# ----------------------------------------------------------------------
def build_vcr_example(item: Dict[str, Any], drawn_jpegs: Dict[str, bytes],
                      vcr_tok: VCRTokenizer,
                      ans_default: int = -1, rat_default: int = -1) -> bytes:
    """One annotation -> serialized Example (reference schema).

    drawn_jpegs: {'answer/bbox': bytes, 'answer/segm': ..., 'rationale/...'}.
    """
    feats: Dict[str, Any] = {
        "img_id": item["img_id"].encode(),
        "annot_id": item["annot_id"].encode(),
        "label/answer_label": [item.get("answer_label", ans_default)],
        "label/rationale_label": [item.get("rationale_label", rat_default)],
    }
    for mode in ("answer", "rationale"):
        for draw in ("bbox", "segm"):
            jpg = drawn_jpegs[f"{mode}/{draw}"]
            feats[f"{mode}/{draw}/image/encoded"] = jpg
            feats[f"{mode}/{draw}/image/format"] = b"jpeg"
            feats[f"{mode}/{draw}/image/key/sha256"] = hashlib.sha256(
                jpg).hexdigest().encode()

        ctx = list(item["question"])
        if mode == "rationale":
            ctx = ctx + list(item["answer_choices"][item["answer_label"]])
        ctx_ids, ctx_tags = vcr_tok(ctx, item["objects"])
        feats[f"{mode}/ctx"] = ctx_ids
        feats[f"{mode}/ctx_tags"] = ctx_tags
        for i, choice in enumerate(item[f"{mode}_choices"]):
            ids, tags = vcr_tok(choice, item["objects"])
            feats[f"{mode}/choice_{i}"] = ids
            feats[f"{mode}/choice_tags_{i}"] = tags
    return encode_example(feats)


def prepare_vcr_shard(annotations_file: str, image_dir: str, out_path: str,
                      fold: int = 0, num_folds: int = 1) -> int:
    """Full offline pipeline for one fold: draw overlays in-memory (instead
    of the reference's two-pass draw_*.sh + read-back) and write the shard."""
    from PIL import Image
    vcr_tok = VCRTokenizer()
    with open(annotations_file) as f:
        items = [json.loads(s) for s in f]

    n = 0
    with TFRecordWriter(out_path) as w:
        for idx, item in enumerate(items):
            if idx % num_folds != fold:
                continue
            with open(os.path.join(image_dir, item["metadata_fn"])) as f:
                meta = json.load(f)
            base = Image.open(os.path.join(image_dir, item["img_fn"]))
            drawn = {}
            for mode in ("answer", "rationale"):
                mentions, objects = collect_mentions(item, mode)
                for kind, shapes in (("bbox", meta["boxes"]),
                                     ("segm", meta["segms"])):
                    img = draw_grounding(base.copy(), shapes, mentions,
                                         objects, kind=kind)
                    buf = io.BytesIO()
                    img.save(buf, format="JPEG", quality=95)
                    drawn[f"{mode}/{kind}"] = buf.getvalue()
            w.write(build_vcr_example(item, drawn, vcr_tok))
            n += 1
    return n
