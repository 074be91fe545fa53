"""Zero-shot visual story ordering via the pretrained temporal heads
(counterpart of merlot_tpu/downstream/sort_story/zero_shot.py).

Per batch:
  * duplicate each story ``duplication_factor`` (= 2) times;
  * give each duplicate a fixed-seed random frame-PE permutation with
    offset +64, so the model treats every frame as shuffled;
  * run MerlotModel without masking, take the CLS state of each segment,
    and apply the ``lang_viz`` / ``viz_viz`` temporal heads;
  * softmax over classes 1..3 (same / earlier / later), mean over the
    duplicates, and dump per-story probs to h5.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, Optional

import numpy as np
import torch

from merlot_tpu_torch.core import threefry
from merlot_tpu_torch.models.merlot import MerlotModel
from merlot_tpu_torch.ops.attention import inference_backend

DUPLICATION_FACTOR = 2
SHUFFLE_OFFSET = 64
SHUFFLE_SEED = 123
SHUFFLE_FOLD = 1234


def default_shuffled_idx(batch_size: int, num_chunks: int,
                         duplication_factor: int = DUPLICATION_FACTOR
                         ) -> torch.Tensor:
    """The JAX package's fixed per-duplicate frame permutations + 64,
    [batch*dup, n] int64: ``uniform(fold_in(PRNGKey(123), 1234),
    (batch*dup*n,))`` reshaped to rows, each row's stable argsort. The
    draw is reproduced bit for bit by ``core.threefry``."""
    rows = batch_size * duplication_factor
    u = threefry.uniform(threefry.fold_in(threefry.prng_key(SHUFFLE_SEED), SHUFFLE_FOLD),
                         rows * num_chunks)
    idx = np.argsort(u.reshape(rows, num_chunks), axis=1, kind="stable")
    return torch.from_numpy(idx).long() + SHUFFLE_OFFSET


def duplicate_inputs(images: torch.Tensor, sentences: torch.Tensor,
                     duplication_factor: int = DUPLICATION_FACTOR):
    """images [batch, n, h, w, 3] -> [batch*dup*n, h, w, 3]; sentences
    [batch, n, L] -> [batch*dup, n, L]. Rows are tiled whole-batch-wise,
    [s0, s1, ..., s0, s1, ...], exactly as the JAX package's ``jnp.tile``."""
    imgs = images.repeat(duplication_factor, 1, 1, 1, 1)
    sents = sentences.repeat(duplication_factor, 1, 1)
    b2, n, h, w, _ = imgs.shape
    return imgs.reshape(b2 * n, h, w, 3), sents


def zero_shot_logits(model: MerlotModel, imgs: torch.Tensor, sents: torch.Tensor,
                     shuffled_idx: torch.Tensor, attn_backend: str
                     ) -> Dict[str, torch.Tensor]:
    """Per-row temporal logits {lang_viz, viz_viz}: [rows*n*n, 4] fp32, for
    already duplicated inputs."""
    h = model.cfg.hidden_size
    fwd = model(imgs, sents[:, :, :32], shuffled_idx_img=shuffled_idx,
                attn_backend=attn_backend)
    s = fwd["shapes"]
    h_lang = fwd["encoder_hidden_states"]["lang"].reshape(
        s["B"], s["group"], s["lang_chunk_len"], h)[:, :, 0]
    h_viz = fwd["encoder_hidden_states"]["viz"].reshape(
        s["B"], s["group"], s["viz_chunk_len"], h)[:, :, 0]
    return {name: model.temporal_logits(xa, h_viz, which=name)
            for name, xa in (("lang_viz", h_lang), ("viz_viz", h_viz))}


def make_zero_shot_fn(batch_size: int, num_chunks: int,
                      duplication_factor: int = DUPLICATION_FACTOR, *,
                      shuffled_idx: Optional[torch.Tensor] = None,
                      attn_backend: Optional[str] = None
                      ) -> Callable[..., Dict[str, torch.Tensor]]:
    """Returns fn(model, images, sentences) -> {lang_viz_probs,
    viz_viz_probs}, each [batch, n, n, 3] fp32.

    ``model`` must be in eval configuration (the port has no dropout).
    ``shuffled_idx``: [batch*dup, n] int, default ``default_shuffled_idx``.
    ``attn_backend``: default ``inference_backend`` of the images' device
    (the kernel on CUDA, the plain path on the CPU)."""
    if shuffled_idx is None:
        shuffled_idx = default_shuffled_idx(batch_size, num_chunks,
                                            duplication_factor)
    shuffled_idx = torch.as_tensor(shuffled_idx).long()

    @torch.no_grad()
    def fn(model: MerlotModel, images: torch.Tensor, sentences: torch.Tensor):
        group = model.cfg.num_chunks_in_group or num_chunks
        if group != num_chunks:
            raise ValueError("zero-shot uses one group per story")
        imgs, sents = duplicate_inputs(images, sentences, duplication_factor)
        backend = attn_backend or inference_backend(images.device)
        logits = zero_shot_logits(model, imgs, sents,
                                  shuffled_idx.to(images.device), backend)
        out = {}
        for name, lg in logits.items():
            probs = torch.softmax(lg, dim=-1)[:, 1:]      # classes 1..3
            # Known fault kept for parity with the JAX package: the rows were
            # tiled [s0, s1, ..., s0, s1, ...] but are read back here as
            # [s0, s0, s1, s1, ...], so for batch_size > 1 every story gets
            # the mean over all stories of the batch. ROADMAP Queue 3 tracks
            # the fix, to land in both packages together.
            probs = probs.reshape(batch_size, duplication_factor,
                                  num_chunks, num_chunks, 3)
            out[f"{name}_probs"] = probs.mean(dim=1)
        return out

    return fn


def run_zero_shot(model: MerlotModel, batches: Iterable[Dict[str, Any]],
                  h5_path: str, batch_size: int, num_chunks: int = 5, *,
                  shuffled_idx: Optional[torch.Tensor] = None) -> int:
    """Drive batches through the zero-shot fn on the model's device and dump
    per-story h5 groups; returns the number of stories written.
    story_batches yields only full batches; stories already written
    (replica padding repeats the last one) are skipped."""
    import h5py

    fn = make_zero_shot_fn(batch_size, num_chunks, shuffled_idx=shuffled_idx)
    device = next(model.parameters()).device
    n = 0
    with h5py.File(h5_path, "w") as h5:
        for batch in batches:
            out = fn(model, torch.as_tensor(np.asarray(batch["images"])).to(device),
                     torch.as_tensor(np.asarray(batch["sentences"])).to(device))
            out = {k: v.cpu().numpy() for k, v in out.items()}
            for i in range(batch_size):
                sid = str(int(batch["story_id"][i]))
                if sid in h5:
                    continue
                grp = h5.create_group(sid)
                grp.create_dataset("permutation_identity_encode",
                                   data=int(batch["permutation_identity_encode"][i]))
                grp.create_dataset("sentences", data=batch["sentences"][i])
                for name in ("lang_viz", "viz_viz"):
                    grp.create_dataset(f"{name}_probs", data=out[f"{name}_probs"][i])
                n += 1
    return n
