"""Download the VIST/SIND story-in-sequence data (counterpart of
merlot_tpu/downstream/sort_story/download.py; needs network access).

    python -m merlot_tpu_torch.downstream.sort_story.download --working_dir D

Fetches the SIS annotations from visionandlanguage.net and the val/test
image tars from VIST's Google Drive mirrors with ``wget``, then unpacks
them with ``tar``. Feed the extracted json and images to
``python -m merlot_tpu_torch.downstream.sort_story.data``.
"""

from __future__ import annotations

import argparse
import os
import subprocess

SIS_URL = ("https://visionandlanguage.net/VIST/json_files/"
           "story-in-sequence/SIS-with-labels.tar.gz")
# VIST's released Google Drive file ids for the eval image tars
GDRIVE_IDS = {
    "val_images.tar.gz": "0ByQS_kT8kViSWmtRa1lMcG1EaHc",
    "test_images.tar.gz": "0ByQS_kT8kViSTHJ0cGxSVW1SRFk",
}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--working_dir", default="data")
    args = ap.parse_args(argv)
    os.makedirs(args.working_dir, exist_ok=True)

    sis_tar = os.path.join(args.working_dir, "SIS-with-labels.tar.gz")
    if not os.path.exists(sis_tar):
        subprocess.run(["wget", SIS_URL, "-O", sis_tar], check=True)
    if not os.path.exists(os.path.join(args.working_dir, "sis")):
        subprocess.run(["tar", "-xf", sis_tar, "-C", args.working_dir], check=True)

    for fname, file_id in GDRIVE_IDS.items():
        dst = os.path.join(args.working_dir, fname)
        if not os.path.exists(dst):
            # Google Drive's direct download
            url = f"https://drive.google.com/uc?export=download&id={file_id}"
            subprocess.run(["wget", "--no-check-certificate", url, "-O", dst], check=True)
        subprocess.run(["tar", "-xf", dst, "-C", args.working_dir], check=True)
    print("done; see", args.working_dir)


if __name__ == "__main__":
    main()
