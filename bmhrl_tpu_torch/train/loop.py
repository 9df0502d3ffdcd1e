"""Training orchestration (the port of bmhrl_tpu/train/loop.py). For now
only the model selection by ``cfg.mode`` that the serving CLIs share with
training; the loop itself comes with the host half of training."""
from __future__ import annotations

from bmhrl_tpu_torch.config import Config


def build_model(cfg: Config, voc_size: int, device="cuda"):
    """The captioner of ``cfg.mode`` on ``device``, its parameters as the
    modules initialise them (load weights with ``weights.load_jax_params``):
    ``BMHrlAgent`` for BMHRL/BM/verbose/eval, ``AudioAgent`` for AHRL,
    ``VideoAgent`` for VHRL. ``cfg.use_pallas_attention`` decides whether
    the encoder sites that qualify run the flash kernel."""
    from bmhrl_tpu_torch.models.bmhrl import BMHrlAgent
    from bmhrl_tpu_torch.models.unimodal import AudioAgent, VideoAgent

    if cfg.mode in ("BMHRL", "BM", "verbose", "eval"):
        return BMHrlAgent(**cfg.agent_kwargs(voc_size), device=device)
    if cfg.mode == "AHRL":
        return AudioAgent.build(cfg, voc_size, device)
    if cfg.mode == "VHRL":
        return VideoAgent.build(cfg, voc_size, device)
    if cfg.mode == "DETR":
        raise NotImplementedError("mode DETR is not ported yet")
    raise ValueError(f"unknown mode {cfg.mode}")
