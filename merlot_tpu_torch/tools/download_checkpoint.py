"""Fetch the released MERLOT TF checkpoints and convert them to this
package's format (counterpart of merlot_tpu/tools/download_checkpoint.py).

The 4- and 5-segment pretrain checkpoints are published at
``gs://merlot/checkpoint_{4,5}segments/model.ckpt.*`` (public HTTPS mirror
``https://storage.googleapis.com/merlot/...``). After the download, the TF1
variables go through ``convert_tf_checkpoint`` into a params-only
checkpoint directory (its tree rooted at ``merlot/``):

    python -m merlot_tpu_torch.tools.download_checkpoint --segments 5 \\
        --out_dir checkpoints_tf --converted out/checkpoints/ckpt_0

The zero-shot CLI reads it from ``output_dir/checkpoints/ckpt_0``; the
pretraining and VCR configs warm-start from it (``model.init_checkpoint``).
Converting needs tensorflow; the checkpoint it writes needs only numpy, so
it can be converted on one machine and copied to another.
"""

from __future__ import annotations

import argparse
import os
import urllib.request

from merlot_tpu_torch.models.config import MerlotConfig
from merlot_tpu_torch.tools.convert_tf_checkpoint import (convert_arrays,
                                                          load_tf_checkpoint_arrays,
                                                          merlot_tf_name_map)
from merlot_tpu_torch.train.checkpoint import save_params_checkpoint

CKPT_FILES = ("model.ckpt.data-00000-of-00001", "model.ckpt.index",
              "model.ckpt.meta")
BASE = "https://storage.googleapis.com/merlot"


def download(segments: int, out_dir: str) -> str:
    os.makedirs(out_dir, exist_ok=True)
    for fname in CKPT_FILES:
        url = f"{BASE}/checkpoint_{segments}segments/{fname}"
        dst = os.path.join(out_dir, fname)
        if os.path.exists(dst):
            print(f"exists: {dst}")
            continue
        print(f"downloading {url}")
        urllib.request.urlretrieve(url, dst)
    return os.path.join(out_dir, "model.ckpt")


def released_config(segments: int) -> MerlotConfig:
    """The released checkpoints' model: the hybrid ResNet [3, 4, 9], the LM
    projection and bias, contrastive width 768; 4 segments of 192x352 or 5
    of 384x384 in a group."""
    return MerlotConfig(
        resnet_layers=(3, 4, 9), do_projection=True, do_bias=True,
        contrastive_size=768, num_chunks_in_group=4 if segments == 4 else 5,
        image_size=(192, 352) if segments == 4 else (384, 384))


def convert(ckpt_prefix: str, out_path: str, segments: int) -> None:
    arrays = load_tf_checkpoint_arrays(ckpt_prefix)
    save_params_checkpoint(out_path, convert_arrays(arrays,
                                                    merlot_tf_name_map(released_config(segments))))
    print(f"saved converted checkpoint to {out_path}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--segments", type=int, default=4, choices=(4, 5))
    ap.add_argument("--out_dir", default="checkpoints_tf")
    ap.add_argument("--converted", default=None,
                    help="also convert to a params-only checkpoint directory at this path")
    args = ap.parse_args(argv)
    prefix = download(args.segments, args.out_dir)
    if args.converted:
        convert(prefix, args.converted, args.segments)


if __name__ == "__main__":
    main()
