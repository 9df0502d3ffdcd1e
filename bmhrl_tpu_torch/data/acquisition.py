"""Online clip acquisition -- the network half of the reference's
``captioning_datasets/video_loader.py`` (the port's copy of
bmhrl_tpu/data/acquisition.py).

Reference behavior covered (file:line):
- ``extract`` (:15-112): per-clip YouTube download, cut to [start, end],
  batch-dispatch into the feature-extraction toolkit with a ``data.txt``
  work list, delete consumed media, tolerate per-clip failures.
- vatex meta mangling (:25-31, :113-130): ``video_id = videoID[:-14]``,
  ``start = videoID[-13:-7]``, ``end = videoID[-6:]``.
- msrvtt meta ``preprocess`` (:166-199): ``video_id = url[32:]``, captions
  joined from the ``sentences`` table, val split by id list.

Design: acquisition is host-side IO with no device involvement, so the
module is a thin orchestration layer over three injectable callables — a
``downloader(video_id, dst_path)``, a ``clipper(src, dst, start, end,
audio)`` and a ``dispatch(cmd)`` extractor runner. Default implementations
are import-gated: pytube, then a ``yt-dlp`` CLI fallback for download;
moviepy, then an ``ffmpeg`` CLI fallback for cutting. On an offline host
the defaults raise with the full recipe instead of failing silently;
everything above the backends is unit-tested with fakes.
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence


@dataclass
class ClipSpec:
    """One clip to acquire: a YouTube id plus a [start, end] second range."""
    video_id: str
    start: int
    end: int
    captions: List[str] = field(default_factory=list)

    @property
    def prefix(self) -> str:
        # filename mangle shared with the feature archives (ref :50-51)
        return f"{self.video_id}_{self.start:06d}_{self.end:06d}"


# --------------------------------------------------------------------------
# Meta parsing
# --------------------------------------------------------------------------

def vatex_meta(json_path: str) -> List[ClipSpec]:
    """Parse a VATEX meta JSON (list of {videoID, enCap}) into ClipSpecs.

    The timestamp range is packed into the videoID's last 13 chars
    (ref video_loader.py:25-31)."""
    with open(json_path, encoding="utf-8") as f:
        rows = json.load(f)
    specs = []
    for r in rows:
        vid = r["videoID"]
        specs.append(ClipSpec(
            video_id=vid[:-14],
            start=int(vid[-13:-7]),
            end=int(vid[-6:]),
            captions=list(r.get("enCap", [])),
        ))
    return specs


def msrvtt_meta(json_path: str,
                val_ids: Optional[Sequence[str]] = None,
                split: str = "all") -> List[ClipSpec]:
    """Parse an MSRVTT data JSON ({videos, sentences}) into ClipSpecs.

    ``video_id`` is the YouTube id carved out of the watch URL
    (``url[32:]``, ref :171); captions come from the sentences table keyed
    by the internal ``video_id`` field (ref :173-176). ``split`` selects
    'val' (ids in ``val_ids``), 'train' (the rest) or 'all'."""
    with open(json_path, encoding="utf-8") as f:
        data = json.load(f)
    caps: Dict[str, List[str]] = {}
    for s in data.get("sentences", []):
        caps.setdefault(s["video_id"], []).append(s["caption"])
    val = set(val_ids or [])
    specs = []
    for v in data["videos"]:
        if split == "val" and v["video_id"] not in val:
            continue
        if split == "train" and v["video_id"] in val:
            continue
        specs.append(ClipSpec(
            video_id=v["url"][32:],
            start=int(v["start time"]),
            end=int(v["end time"]),
            captions=caps.get(v["video_id"], []),
        ))
    return specs


# --------------------------------------------------------------------------
# Default backends (import-gated)
# --------------------------------------------------------------------------

_RECIPE = (
    "Acquisition needs a network-capable host. Pipeline per clip: download "
    "the source video (pytube or yt-dlp), cut to [start, end] (moviepy or "
    "ffmpeg; audio as 44.1 kHz stereo pcm_s32le wav), then run the "
    "`video_features` extraction toolkit over the batch list to produce "
    "{prefix}_rgb.npy/{prefix}_flow.npy (I3D, 25 fps, stack/step 64) or "
    "{prefix}_vggish.npy. Finish with video_tools.filter_missing_features "
    "+ convert_meta_to_json."
)


def default_downloader(video_id: str, dst_path: str) -> None:
    """Download the lowest-resolution progressive mp4 for ``video_id``
    (the reference's stream choice, :66) to ``dst_path``.

    Tries pytube, then a yt-dlp CLI; raises with the full recipe when
    neither is available (offline image)."""
    url = f"http://youtube.com/watch?v={video_id}"
    try:
        from pytube import YouTube  # type: ignore
    except ImportError:
        YouTube = None
    if YouTube is not None:
        stream = (YouTube(url, use_oauth=True, allow_oauth_cache=True)
                  .streams.filter(progressive=True, file_extension="mp4")
                  .order_by("resolution").asc().first())
        stream.download(os.path.dirname(dst_path) or ".",
                        filename=os.path.basename(dst_path))
        return
    ytdlp = shutil.which("yt-dlp")
    if ytdlp is not None:
        subprocess.run(
            [ytdlp, "-f", "mp4", "-o", dst_path, url],
            check=True, capture_output=True)
        return
    raise RuntimeError("no download backend (pytube / yt-dlp). " + _RECIPE)


def default_clipper(src: str, dst: str, start: int, end: int,
                    audio: bool) -> None:
    """Cut ``src`` to [start, end] seconds. Video output drops the audio
    track; audio output is 44.1 kHz stereo pcm_s32le (ref :76-83).

    Tries moviepy, then an ffmpeg CLI; raises with the recipe otherwise."""
    try:
        import moviepy.editor as mpe  # type: ignore
    except ImportError:
        mpe = None
    if mpe is not None:
        if audio:
            clip = mpe.AudioFileClip(src).subclip(start, end)
            clip.write_audiofile(dst, 44100, 2, 2000, "pcm_s32le")
        else:
            clip = mpe.VideoFileClip(src).subclip(start, end)
            clip.write_videofile(dst, audio=False)
        return
    ffmpeg = shutil.which("ffmpeg")
    if ffmpeg is not None:
        codec = (["-vn", "-acodec", "pcm_s32le", "-ar", "44100", "-ac", "2"]
                 if audio else ["-an", "-c:v", "libx264"])
        subprocess.run(
            [ffmpeg, "-y", "-ss", str(start), "-to", str(end), "-i", src,
             *codec, dst],
            check=True, capture_output=True)
        return
    raise RuntimeError("no clip backend (moviepy / ffmpeg). " + _RECIPE)


def _popen_dispatch(cmd: str) -> subprocess.Popen:
    return subprocess.Popen(cmd, shell=True)


# --------------------------------------------------------------------------
# Acquisition loop
# --------------------------------------------------------------------------

def feature_done_path(spec: ClipSpec, feature_type: str, root: str) -> str:
    """The extracted-feature file whose existence marks a clip done
    (the reference's skip check, :50-57: the i3d flow file or the vggish
    file under data_extract/{dataset}/{kind}/)."""
    if "i3d" in feature_type:
        return os.path.join(root, "i3d", f"{spec.prefix}_flow.npy")
    return os.path.join(root, "vggish", f"{spec.prefix}_vggish.npy")


def acquire(
    specs: Sequence[ClipSpec],
    feature_type: str,
    work_dir: str,
    extract_cmd: str,
    feature_root: str,
    downloader: Callable[[str, str], None] = default_downloader,
    clipper: Callable[[str, str, int, int, bool], None] = default_clipper,
    dispatch: Callable[[str], subprocess.Popen] = _popen_dispatch,
    batch_size: int = 50,
    list_file: str = "data.txt",
    log: Callable[[str], None] = lambda _m: None,
) -> Dict[str, int]:
    """Download + cut every clip in ``specs`` and batch-dispatch the
    feature extractor, reproducing the reference ``extract`` loop
    (:34-112): skip clips whose features already exist, keep at most one
    extractor running (wait, then delete the media it consumed per the
    work list), tolerate any per-clip failure, and flush the final
    partial batch. Returns {downloaded, skipped, failed} counts."""
    audio = "vggish" in feature_type
    os.makedirs(work_dir, exist_ok=True)
    stats = {"downloaded": 0, "skipped": 0, "failed": 0}
    batch: List[str] = []
    pending: Optional[subprocess.Popen] = None

    def flush() -> None:
        nonlocal pending, batch
        if not batch:
            return
        if pending is not None:
            pending.wait()
            # remove the media files the finished extractor consumed
            # (ref :95-99: the previous work list is re-read and deleted)
            try:
                with open(list_file, encoding="utf-8") as f:
                    for line in f:
                        p = line.strip()
                        if p and os.path.exists(p):
                            os.remove(p)
            except FileNotFoundError:
                pass
        with open(list_file, "w", encoding="utf-8") as f:
            f.write("\n".join(batch) + "\n")
        pending = dispatch(extract_cmd)
        batch = []

    for spec in specs:
        if os.path.exists(feature_done_path(spec, feature_type,
                                            feature_root)):
            stats["skipped"] += 1
            continue
        name = spec.prefix + (".wav" if audio else ".mp4")
        tmp = os.path.join(work_dir, "tmp_" + name)
        dst = os.path.join(work_dir, name)
        try:
            downloader(spec.video_id, tmp)
            clipper(tmp, dst, spec.start, spec.end, audio)
        except Exception as e:  # noqa: BLE001 (ref :88-91 catches all)
            log(f"{spec.prefix}: {type(e).__name__}: {e}")
            stats["failed"] += 1
            continue
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
        stats["downloaded"] += 1
        batch.append(dst)
        if len(batch) >= batch_size:
            flush()
    flush()
    if pending is not None:
        pending.wait()
    return stats
