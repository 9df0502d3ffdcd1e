"""VATEX training rows (the port's copy of bmhrl_tpu/data/vatex.py): a
``videoID`` "XXX_000006_000016" splits into the base id and the start and
end seconds; every row keeps all its English captions, of which the
dataset picks one per epoch. The feature files of a row go by the mangled
id ``feature_id()`` (in ``i3d_vatex`` / ``vggish_vatex`` beside the train
meta file)."""
from __future__ import annotations

import json
from typing import List

from bmhrl_tpu_torch.data.tokenizer import tokenize_lower


class VatexRow:
    __slots__ = ("base_id", "captions", "start", "end", "duration", "tokens")

    def __init__(self, base_id, captions, start, end):
        self.base_id = base_id
        self.captions = captions
        self.start = float(start)
        self.end = float(end)
        self.duration = float(end - start)
        self.tokens = [tokenize_lower(c) for c in captions]

    def feature_id(self) -> str:
        """The mangled id of the row's feature files."""
        return f"{self.base_id}_{int(self.start):06d}_{int(self.end):06d}"


def convert_vatex_training(json_path: str) -> List[VatexRow]:
    """``vatex_training.json`` (a list of ``{videoID, enCap}`` or the same
    as a column dict) -> rows."""
    with open(json_path) as f:
        data = json.load(f)
    if isinstance(data, dict):  # column-oriented
        ids = data["videoID"]
        caps = data["enCap"]
        items = [{"videoID": ids[k], "enCap": caps[k]} for k in ids]
    else:
        items = data
    rows = []
    for item in items:
        vid = item["videoID"]
        caps = item["enCap"]
        if isinstance(caps, str):
            caps = [caps]
        rows.append(VatexRow(vid[:-14], caps, int(vid[-13:-7]),
                             int(vid[-6:])))
    return rows
