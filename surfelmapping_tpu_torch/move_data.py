"""Renumber generated novel-view (image, semantic) pairs into a dataset dir
(the root ``move_data.py``'s counterpart in the port).

    python -m surfelmapping_tpu_torch.move_data --offset N -t DEST [-s SRC] [-f]

Takes every ``<id>.png`` under ``<source>/{image,semantic}``, adds
``--offset`` to the frame id, and moves it to
``<destination>/{image,semantic}/<id+offset 0-padded to 6>.png``.
``--fake`` prints the operations without performing them.
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--offset", type=int, required=True,
                    help="frame number offset (add)")
    ap.add_argument("-t", "--destination", type=str, required=True,
                    help="destination directory")
    ap.add_argument("-s", "--source", type=str, default="./output/novel",
                    help="source directory holding image/ and semantic/")
    ap.add_argument("-f", "--fake", action="store_true",
                    help="print operations without performing them")
    args = ap.parse_args(argv)

    for data_dir in ("image", "semantic"):
        src_dir = os.path.join(args.source, data_dir)
        dst_dir = os.path.join(args.destination, data_dir)
        if not os.path.isdir(src_dir):
            print(f"skip missing {src_dir}")
            continue
        if not args.fake:
            os.makedirs(dst_dir, exist_ok=True)
        for name in sorted(os.listdir(src_dir)):
            base_id = int(name.split(".")[0])
            dest_name = f"{base_id + args.offset:0>6d}.png"
            src = os.path.join(src_dir, name)
            dst = os.path.join(dst_dir, dest_name)
            print(f"mv {src} {dst}")
            if not args.fake:
                shutil.move(src, dst)
    return 0


if __name__ == "__main__":
    sys.exit(main())
