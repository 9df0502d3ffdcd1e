"""Synthetic 6-class captioning task (the port's copy of
bmhrl_tpu/utils/synthetic.py): each class pairs a fixed caption with a
class-signature feature direction, and a clip is its signature plus
Gaussian noise, so a captioner has to tie feature content to word
sequences to score on held-out clips. ``generate`` writes the same files,
byte for byte, as the JAX package's from the same seed: the port's
learning proof (``cli.synthetic_proof``) and its tests train on it.

Layout: ``{out}/i3d/{vid}_{rgb,flow}.npy``, ``{out}/vggish/{vid}.npy``,
``{out}/train.csv``, ``{out}/val_1.csv`` (held-out clips),
``{out}/val_1_ref.json`` (ActivityNet-format references).
"""
from __future__ import annotations

import json
import os
from typing import Dict, List

import numpy as np

# class -> caption; simple visual scenes in ActivityNet register
CLASSES: List[str] = [
    "A man is running on the track",
    "A chef cooks food in the kitchen",
    "A woman plays the piano on stage",
    "A dog jumps over the fence",
    "Children swim in the pool",
    "A girl dances in the studio",
]

D_RGB = D_FLOW = 1024
D_AUDIO = 128


def generate(
    out_dir: str,
    clips_per_class: int = 30,
    val_per_class: int = 4,
    noise: float = 0.5,
    seed: int = 0,
    d_rgb: int = D_RGB,
    d_audio: int = D_AUDIO,
) -> Dict[str, str]:
    """Write the corpus; returns the paths a Config needs."""
    rng = np.random.RandomState(seed)
    vdir = os.path.join(out_dir, "i3d")
    adir = os.path.join(out_dir, "vggish")
    os.makedirs(vdir, exist_ok=True)
    os.makedirs(adir, exist_ok=True)

    sig_rgb = rng.randn(len(CLASSES), d_rgb).astype(np.float32)
    sig_flow = rng.randn(len(CLASSES), d_rgb).astype(np.float32)
    sig_aud = rng.randn(len(CLASSES), d_audio).astype(np.float32)

    header = "video_id\tcaption\tstart\tend\tduration\tphase\tidx\n"
    rows = {"train": [], "val_1": []}
    refs: Dict[str, Dict] = {}
    for c, caption in enumerate(CLASSES):
        for i in range(clips_per_class + val_per_class):
            phase = "train" if i < clips_per_class else "val_1"
            vid = f"v_syn_c{c}_{i:03d}"
            tv = int(rng.randint(10, 17))
            ta = int(rng.randint(24, 41))
            rgb = sig_rgb[c] + noise * rng.randn(tv, d_rgb)
            flow = sig_flow[c] + noise * rng.randn(tv, d_rgb)
            aud = sig_aud[c] + noise * rng.randn(ta, d_audio)
            np.save(os.path.join(vdir, f"{vid}_rgb.npy"),
                    rgb.astype(np.float32))
            np.save(os.path.join(vdir, f"{vid}_flow.npy"),
                    flow.astype(np.float32))
            np.save(os.path.join(adir, f"{vid}.npy"), aud.astype(np.float32))
            dur = float(tv)
            rows[phase].append((vid, caption, 0.0, dur, dur, phase))
            if phase == "val_1":
                refs[vid] = {"duration": dur, "timestamps": [[0.0, dur]],
                             "sentences": [caption]}

    paths = {}
    for phase, rws in rows.items():
        p = os.path.join(out_dir, f"{phase}.csv")
        with open(p, "w") as f:
            f.write(header)
            for idx, (vid, cap, s, e, d, ph) in enumerate(rws):
                f.write(f"{vid}\t{cap}\t{s}\t{e}\t{d}\t{ph}\t{idx}\n")
        paths[phase] = p
    ref_path = os.path.join(out_dir, "val_1_ref.json")
    with open(ref_path, "w") as f:
        json.dump(refs, f)
    paths["ref"] = ref_path
    paths["video_features_path"] = vdir
    paths["audio_features_path"] = adir
    return paths
