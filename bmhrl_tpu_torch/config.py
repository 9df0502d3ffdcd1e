"""Configuration: the fields of bmhrl_tpu.config.Config that the greedy
serving path and the training steps read, with the same names and
defaults."""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple


@dataclasses.dataclass
class Config:
    # features
    video_features_path: str = "./data/i3d_25fps_stack64step64_2stream_npy/"
    audio_features_path: str = "./data/vggish_npy/"
    d_vid: int = 1024
    d_aud: int = 128
    pad_audio_feats_up_to: int = 800
    pad_video_feats_up_to: int = 300
    video_buckets: Tuple[int, ...] = (32, 64, 128, 224, 300)
    audio_buckets: Tuple[int, ...] = (64, 128, 256, 512, 800)
    # decoding
    max_len: int = 30
    B: int = 16  # per-device batch; serving batches hold inf_B_coeff * B
    inf_B_coeff: int = 2
    # model
    d_model: int = 1024
    d_model_caps: int = 300
    rl_att_heads: int = 4
    rl_att_layers: int = 2
    rl_goal_d: int = 64
    rl_ff_v: int = 1024
    rl_ff_a: int = 512
    rl_ff_c: int = 2048
    rl_critic_score_threshhold: float = 0.25
    compute_dtype: str = "bfloat16"
    # the production setting: encoder attention sites that qualify run the
    # flash kernel
    use_pallas_attention: bool = True
    # training
    dout_p: float = 0.1
    smoothing: float = 0.7
    grad_clip: Optional[float] = None
    betas: Tuple[float, float] = (0.9, 0.999)
    # the captioner's Adam eps as the JAX package writes it (1e-4; the
    # reference's effective value is 1e-8, see VERDICT.md)
    eps: float = 1e-4
    weight_decay: float = 0.0
    rl_cap_warmstart_lr: float = 1e-4
    rl_cap_lr: float = 1e-4
    rl_value_function_lr: float = 1e-4
    rl_stabilize: bool = True

    def agent_kwargs(self, voc_size: int) -> Dict:
        """``BMHrlAgent`` arguments of this configuration."""
        import torch

        return dict(voc_size=voc_size, d_video=self.d_vid,
                    d_audio=self.d_aud, d_model=self.d_model,
                    d_model_caps=self.d_model_caps,
                    att_heads=self.rl_att_heads,
                    att_layers=self.rl_att_layers, dout_p=self.dout_p,
                    d_goal=self.rl_goal_d,
                    d_ff_v=self.rl_ff_v, d_ff_a=self.rl_ff_a,
                    d_ff_c=self.rl_ff_c,
                    critic_score_threshold=self.rl_critic_score_threshhold,
                    dtype=getattr(torch, self.compute_dtype),
                    use_flash=self.use_pallas_attention)

    @property
    def inference_batch_size(self) -> int:
        """Serving batch on one card (the JAX package multiplies by the
        number of data-parallel devices)."""
        return self.inf_B_coeff * self.B

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)
