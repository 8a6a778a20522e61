"""Raw AI City annotations -> clip labels + ffmpeg cut commands (port of
``tools/aicity_convert_anno.py``). Video lengths come from
:func:`~aicity_action_tpu_torch.data.decoder.video_meta`: the port's FFmpeg
library where it applies, cv2 elsewhere.

Usage:
    python -m aicity_action_tpu_torch.tools.aicity_convert_anno ANNO_FILE \
        VIDEO_PATH OUT_ANNO_FILE CLIP_CMDS TARGET_PATH [--resolution -2:540]
"""

from __future__ import annotations

import argparse
import os


def main(argv=None) -> list[tuple[str, int]]:
    """Writes the clip rows and cut commands; returns the rows."""
    p = argparse.ArgumentParser()
    p.add_argument("anno_file")
    p.add_argument("video_path")
    p.add_argument("out_anno_file")
    p.add_argument("clip_cmds")
    p.add_argument("target_path")
    p.add_argument("--resolution", default="-2:540")
    args = p.parse_args(argv)

    from ..data.decoder import video_meta
    from ..pipeline.anno import convert_annotations

    def video_length(video_file):
        path = os.path.join(args.video_path, video_file)
        if not os.path.exists(path):
            return None
        n, fps = video_meta(path)
        return n / (fps or 30.0)

    rows = convert_annotations(
        args.anno_file,
        video_length,
        out_anno_file=args.out_anno_file,
        clip_cmds_file=args.clip_cmds,
        video_path=args.video_path,
        target_path=args.target_path,
        resolution=args.resolution,
    )
    print(f"wrote {len(rows)} clip rows to {args.out_anno_file}")
    return rows


if __name__ == "__main__":
    main()
