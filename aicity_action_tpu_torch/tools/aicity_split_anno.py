"""Leave-one-user-out splits from converted annotations (port of
``tools/aicity_split_anno.py``).

Usage:
    python -m aicity_action_tpu_torch.tools.aicity_split_anno ANNO_FILE \
        OUT_PATH [--method 1|2]
"""

from __future__ import annotations

import argparse


def main(argv=None) -> list[str]:
    """Writes ``splits_<i>/{train,val}.csv``; returns their directories."""
    p = argparse.ArgumentParser()
    p.add_argument("anno_file")
    p.add_argument("out_path")
    p.add_argument("--method", type=int, choices=[1, 2], default=2)
    args = p.parse_args(argv)

    from ..pipeline.anno import make_user_splits

    dirs = make_user_splits(args.anno_file, args.out_path, args.method)
    print(f"wrote {len(dirs)} splits under {args.out_path}")
    return dirs


if __name__ == "__main__":
    main()
