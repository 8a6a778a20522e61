"""AI City annotation preparation (a copy of
``aicity_action_tpu/pipeline/anno.py``).

Re-designs `scripts/aicity_convert_anno.py` and `scripts/aicity_split_anno.py`:

- :func:`convert_annotations` — raw challenge csv → per-clip
  ``(clip_id, action_id)`` rows plus ffmpeg cut commands; fills the
  unannotated gaps as class "empty" (-2) and normalizes the per-user
  filename inconsistencies of the raw data
- :func:`make_user_splits` — leave-one-user-out cross-validation splits with
  the NA(-1)/empty(-2) → class-0 policy
"""

from __future__ import annotations

import os
from collections import defaultdict
from typing import Callable, Optional



def time2int(time_str: str) -> int:
    minutes, seconds = time_str.split(":")
    return int(minutes) * 60 + int(seconds)


def int2time(secs: float) -> str:
    m, s = divmod(secs, 60)
    return f"{int(m):02d}:{s:06.3f}"


# per-user filename quirks in the raw annotations (convert_anno.py:36-60)
_VIEW_FIX = {
    ("24026", "Rightside_window"): "Right_side_window",
    ("24026", "Rearview"): "Rear_view",
    ("24026", "Rightside window"): "Right_side_window",
    ("38058", "Rightside_window"): "Right_side_window",
    ("38058", "Rearview"): "Rear_view",
    ("38058", "Rightside window"): "Right_side_window",
    ("35133", "Rearview"): "Rear_view",
    ("35133", "Rightside window"): "Rightside_window",
    ("49381", "Rear_view"): "Rearview_mirror",
    ("49381", "Rightside_window"): "Right_window",
}
_CAPITAL_USER = {"24026", "38058"}  # these use "User_id" capitalization


def normalize_file_name(file_name: str, user_id: str, view: str) -> str:
    """Annotation name → actual video file stem (without .MP4)."""
    perform_id = file_name[-1]
    if user_id == "38508":  # known typo in the raw annotations
        user_id = "38058"
    view = _VIEW_FIX.get((user_id, view), view)
    word = "User_id" if user_id in _CAPITAL_USER else "user_id"
    return f"{view}_{word}_{user_id}_NoAudio_{perform_id}"


def convert_annotations(
    anno_file: str,
    video_length_fn: Callable[[str], Optional[float]],
    *,
    out_anno_file: str,
    clip_cmds_file: Optional[str] = None,
    video_path: str = "",
    target_path: str = "",
    resolution: str = "-2:540",
) -> list[tuple[str, int]]:
    """Convert raw annotations to clip rows; optionally emit cut commands.

    ``video_length_fn(video_file) -> seconds`` supplies video durations
    (None to skip gap-filling for that video).
    Returns the written ``(clip_id, action_id)`` rows.
    """
    data = defaultdict(list)
    vid_to_seg: dict[str, set] = defaultdict(set)

    with open(anno_file) as f:
        lines = f.readlines()[1:]
    for line in lines:
        (user_id, video_file_name, view, _, start, end,
         action_id, _block) = line.strip().split(",")
        stem = normalize_file_name(
            video_file_name.strip(), user_id.strip(), view.strip()
        )
        video_file = f"{stem}.MP4"
        s, e = time2int(start), time2int(end)
        key = (s, e)
        assert key not in vid_to_seg[video_file], f"overlap: {line}"
        vid_to_seg[video_file].add(key)
        data[video_file].append(
            (user_id.strip(), video_file, s, e, action_id.strip())
        )

    # fill unannotated gaps as "empty"
    data_empty: dict[str, list] = {}
    for video_file, segs in data.items():
        user_id = segs[0][0]
        max_len = video_length_fn(video_file)
        bounds = [(None, None, 0, 0, 0)] + segs
        if max_len is not None and max_len > segs[-1][3]:
            bounds.append((None, None, int(max_len), 0, 0))
        empty = []
        for s1, s2 in zip(bounds[:-1], bounds[1:]):
            gap = s2[2] - s1[3]
            if gap > 0:
                empty.append((user_id, video_file, s1[3], s2[2], "empty"))
        data_empty[video_file] = empty

    rows: list[tuple[str, int]] = []
    cut_cmds: list[str] = []
    for video_file, segs in data.items():
        for user_id, _, s, e, action in segs + data_empty[video_file]:
            clip_id = f"{os.path.splitext(video_file)[0]}.{user_id}.{s}.{e}.MP4"
            if action == "NA":
                aid = -1
            elif action == "empty":
                aid = -2
            else:
                aid = int(action)
            rows.append((clip_id, aid))
            cut_cmds.append(
                f"ffmpeg -nostdin -y -i "
                f"{os.path.join(video_path, video_file)} "
                f"-vf scale={resolution} -c:v libx264 "
                f"-ss {int2time(s)} -to {int2time(e)} "
                f"{os.path.join(target_path, clip_id)}\n"
            )

    with open(out_anno_file, "w") as f:
        for clip_id, aid in rows:
            f.write(f"{clip_id} {aid}\n")
    if clip_cmds_file:
        with open(clip_cmds_file, "w") as f:
            f.writelines(cut_cmds)
    return rows


def make_user_splits(
    anno_file: str, out_path: str, method: int = 2
) -> list[str]:
    """Leave-one-user-out splits (split_anno.py:23-67).

    method 1: drop empty(-2), NA(-1) → 0; method 2: both → class 0.
    Returns the created split directories.
    """
    data: dict[str, list] = defaultdict(list)
    with open(anno_file) as f:
        for line in f:
            video_file, action_id = line.strip().split()
            user_id = video_file.split(".")[1]
            aid = int(action_id)
            if aid in (-1, -2):
                if method == 1 and aid == -2:
                    continue
                aid = 0
            assert aid in range(18), aid
            data[user_id].append((video_file, aid))

    dirs = []
    for i, user_id in enumerate(data.keys()):
        target = os.path.join(out_path, f"splits_{i + 1}")
        os.makedirs(target, exist_ok=True)
        val = data[user_id]
        train = [x for u, rows in data.items() if u != user_id for x in rows]
        with open(os.path.join(target, "train.csv"), "w") as f:
            for v, a in train:
                f.write(f"{v} {a}\n")
        with open(os.path.join(target, "val.csv"), "w") as f:
            for v, a in val:
                f.write(f"{v} {a}\n")
        dirs.append(target)
    return dirs
