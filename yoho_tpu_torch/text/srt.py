"""Minimal SRT / WebVTT subtitle parser and composer.

A copy of the JAX package's ``text/srt.py`` (which imports no JAX): parse,
compose and ``sort_and_reindex`` of SRT cues, the WebVTT composer, and
``segments_to_subtitles`` for the OpenAI endpoint's ``srt`` and ``vtt``
response formats.
"""

from __future__ import annotations

import datetime as dt
import re
from dataclasses import dataclass, field
from typing import Iterable, Iterator, List

_TS = re.compile(r"(\d+):(\d{1,2}):(\d{1,2})[,.](\d{1,3})")


@dataclass
class Subtitle:
    index: int
    start: dt.timedelta
    end: dt.timedelta
    content: str
    proprietary: str = field(default="")


def _parse_ts(s: str) -> dt.timedelta:
    m = _TS.fullmatch(s.strip())
    if not m:
        raise ValueError(f"bad SRT timestamp: {s!r}")
    h, mnt, sec, ms = m.groups()
    return dt.timedelta(
        hours=int(h), minutes=int(mnt), seconds=int(sec), milliseconds=int(ms.ljust(3, "0"))
    )


def _fmt_ts(td: dt.timedelta) -> str:
    total_ms = round(td.total_seconds() * 1000)
    h, rem = divmod(total_ms, 3_600_000)
    m, rem = divmod(rem, 60_000)
    s, ms = divmod(rem, 1000)
    return f"{h:02d}:{m:02d}:{s:02d},{ms:03d}"


def _is_cue_header(line: str) -> bool:
    """A timestamp header line: ``HH:MM:SS,mmm --> ...``. Anchoring on the
    leading timestamp (not just '-->') keeps content lines that happen to
    contain an arrow from being mistaken for cue boundaries."""
    if "-->" not in line:
        return False
    return _TS.fullmatch(line.split("-->", 1)[0].strip()) is not None


def parse_srt(data: str) -> Iterator[Subtitle]:
    """Parse SRT text into subtitles.

    Cues are anchored on timestamp header lines rather than blank-line
    blocks: real-world SRT content may contain INTERNAL blank lines, which
    a blank-line splitter would silently truncate (dropping trailing lines
    of the cue — the ``srt`` package this module replaces keeps content
    until the next cue header, and so does this).
    """
    lines = data.replace("\r\n", "\n").strip("﻿").strip().split("\n")
    headers = [i for i, ln in enumerate(lines) if _is_cue_header(ln)]
    for n, i in enumerate(headers):
        index = 0
        if i > 0 and re.fullmatch(r"\d+", lines[i - 1].strip()):
            index = int(lines[i - 1].strip())
        # Content runs to the next cue header, excluding its index line.
        stop = headers[n + 1] if n + 1 < len(headers) else len(lines)
        if (n + 1 < len(headers) and stop - 1 > i
                and re.fullmatch(r"\d+", lines[stop - 1].strip())):
            stop -= 1
        # Tolerate cue-position attributes after the end stamp
        # ("... --> 00:00:04,000 X1:100") and stray '-->' later in the
        # line — real-world SRT corpora carry both.
        start_s, end_s = lines[i].split("-->", 1)
        start_s = start_s.strip()
        end_s = end_s.strip().split(" ")[0].split("-->")[0].strip()
        content = "\n".join(lines[i + 1 : stop]).strip()
        try:
            start, end = _parse_ts(start_s), _parse_ts(end_s)
        except ValueError:
            continue  # garbage end stamp: drop the cue, keep parsing
        yield Subtitle(index=index, start=start, end=end, content=content)


def sort_and_reindex(subs: Iterable[Subtitle], start_index: int = 1) -> List[Subtitle]:
    out = sorted(subs, key=lambda s: (s.start, s.end))
    for i, s in enumerate(out):
        s.index = start_index + i
    return out


def compose_srt(subs: Iterable[Subtitle]) -> str:
    parts = []
    for i, s in enumerate(subs):
        idx = s.index if s.index else i + 1
        parts.append(f"{idx}\n{_fmt_ts(s.start)} --> {_fmt_ts(s.end)}\n{s.content}\n")
    return "\n".join(parts)


def _fmt_ts_vtt(td: dt.timedelta) -> str:
    total_ms = round(td.total_seconds() * 1000)
    h, rem = divmod(total_ms, 3_600_000)
    m, rem = divmod(rem, 60_000)
    s, ms = divmod(rem, 1000)
    return f"{h:02d}:{m:02d}:{s:02d}.{ms:03d}"


def compose_vtt(subs: Iterable[Subtitle]) -> str:
    """WebVTT composer (same cue model as SRT; dot millisecond separator,
    WEBVTT header, no numeric indices required)."""
    parts = ["WEBVTT\n"]
    for s in subs:
        parts.append(f"{_fmt_ts_vtt(s.start)} --> {_fmt_ts_vtt(s.end)}\n{s.content}\n")
    return "\n".join(parts)


def segments_to_subtitles(segments) -> List[Subtitle]:
    """Transcription ``Segment``s (start/end seconds, text, optional
    speaker) -> Subtitle cues, speaker-prefixed when diarized."""
    subs = []
    for i, seg in enumerate(segments):
        text = seg.text
        name = getattr(seg, "speaker_name", None)
        speaker = getattr(seg, "speaker", None)
        if name:  # enrolled identity beats the anonymous cluster id
            text = f"[{name}] {text}"
        elif speaker is not None:
            text = f"[speaker {speaker}] {text}"
        subs.append(Subtitle(
            index=i + 1,
            start=dt.timedelta(seconds=float(seg.start)),
            end=dt.timedelta(seconds=float(max(seg.end, seg.start))),
            content=text,
        ))
    return subs
