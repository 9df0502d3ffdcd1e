"""Experiment configuration: the port's copy of bmhrl_tpu.config.Config,
every field with the same name and default, so a ``--config_json`` that
the JAX CLIs take is taken here too (and a key that Config lacks raises
TypeError, as the dataclass does there).

``mesh_shape`` (d, m) is the data-parallel mesh (``parallel.mesh``): d
ranks, one per device (0: every device). ``B`` is the batch of one device,
so ``train_batch_size`` is ``B`` x d and ``inference_batch_size``
``inf_B_coeff`` x that, the global batches, as in the JAX Config. The
values the JAX Config derives at construction (``curr_time``,
``train_batch_size``, ``log_path``, ``model_checkpoint_path``) are plain
attributes here, set the same way."""
from __future__ import annotations

import dataclasses
import os
from time import localtime, strftime
from typing import Dict, Optional, Sequence, Tuple


@dataclasses.dataclass
class Config:
    # procedure / mode -------------------------------------------------------
    procedure: str = "train_rl_cap"
    mode: str = "BMHRL"  # DETR | BMHRL | BM | AHRL | VHRL | verbose | eval
    scorer: str = "CIDER"  # CIDER | METEOR | BLEU
    with_reinforce: bool = False
    pre_goal_attention: bool = False

    # dataset ----------------------------------------------------------------
    train_meta_path: str = "./data/train.csv"
    val_1_meta_path: str = "./data/val_1.csv"
    val_2_meta_path: str = "./data/val_2.csv"
    vatex_meta_path: str = "./data/vatex_val.csv"
    msrvtt_meta_path: str = "./data/msrvtt_val.csv"
    val_prop_meta_path: Optional[str] = None
    train_with_all: bool = False
    vatex_training_json: str = "./data/vatex_training.json"
    modality: str = "audio_video"  # audio | video | audio_video
    video_feature_name: str = "i3d"
    audio_feature_name: str = "vggish"
    video_features_path: str = "./data/i3d_25fps_stack64step64_2stream_npy/"
    audio_features_path: str = "./data/vggish_npy/"
    d_vid: int = 1024
    d_aud: int = 128
    word_emb_caps: str = "glove.840B.300d"
    glove_path: Optional[str] = None  # GloVe .txt; None: random embedding
    unfreeze_word_emb: bool = False
    start_token: str = "<s>"
    end_token: str = "</s>"
    pad_token: str = "<blank>"
    max_len: int = 30
    min_freq_caps: int = 1

    # rl agent ---------------------------------------------------------------
    rl_high_level_enc_d: int = 256
    rl_low_level_enc_d: int = 512
    rl_worker_lstm: int = 1024
    rl_manager_lstm: int = 256
    rl_goal_d: int = 64
    rl_attn_d: int = 512
    rl_critic_path: str = "./data/models/critic.cp"
    rl_critic_score_threshhold: float = 0.25
    rl_gamma_worker: float = 0.0
    rl_gamma_manager: float = 0.0
    rl_pretrained_model_dir: Optional[str] = None
    rl_train_worker: bool = True
    rl_warmstart_epochs: int = 0
    rl_projection_d: int = 512
    rl_att_heads: int = 4
    rl_att_layers: int = 2
    rl_reward_weight_worker: float = 1.0
    rl_reward_weight_manager: float = 2.0
    rl_ff_c: int = 2048
    rl_ff_v: int = 1024
    rl_ff_a: int = 512
    rl_stabilize: bool = True
    rl_value_function_lr: float = 1e-4
    rl_cap_warmstart_lr: float = 1e-4
    rl_cap_lr: float = 1e-4

    # model ------------------------------------------------------------------
    d_model: int = 1024
    d_model_caps: int = 300
    d_model_video: Optional[int] = None
    d_model_audio: Optional[int] = None
    use_linear_embedder: bool = False
    dout_p: float = 0.1

    # training ---------------------------------------------------------------
    B: int = 16  # per-device batch; serving batches hold inf_B_coeff * B
    inf_B_coeff: int = 2
    epoch_num: int = 50
    one_by_one_starts_at: int = 0
    early_stop_after: int = 30
    smoothing: float = 0.7
    grad_clip: Optional[float] = None
    optimizer: str = "adam"
    betas: Tuple[float, float] = (0.9, 0.999)
    # the captioner's Adam eps as the JAX package writes it (1e-4; the
    # reference's effective value is 1e-8, see VERDICT.md)
    eps: float = 1e-4
    lr: float = 1e-5
    weight_decay: float = 0.0
    scheduler: str = "constant"  # constant | reduce_on_plateau
    seed: int = 0

    # feature padding --------------------------------------------------------
    pad_audio_feats_up_to: int = 800
    pad_video_feats_up_to: int = 300

    # evaluation -------------------------------------------------------------
    reference_paths: Sequence[str] = (
        "./data/val_1_no_missings.json",
        "./data/val_2_no_missings.json",
        "./data/vatex_no_missings.json",
        "./data/msrvtt_no_missings.json",
    )
    tIoUs: Sequence[float] = (0.3, 0.5, 0.7, 0.9)
    max_prop_per_vid: int = 100
    prop_pred_path: Optional[str] = None
    meteor_preset: str = "nltk"
    meteor_paraphrase_path: Optional[str] = None
    avail_mp4_path: str = "./data/available_mp4.txt"

    # logging ----------------------------------------------------------------
    to_log: bool = True
    log_dir: str = "./log/"

    # ----- the JAX package's additions --------------------------------------
    mesh_shape: Tuple[int, int] = (0, 1)
    # matmul/activation dtype; params stay f32
    compute_dtype: str = "bfloat16"
    # sequence buckets of the serving planner; captions always max_len+2
    video_buckets: Tuple[int, ...] = (32, 64, 128, 224, 300)
    audio_buckets: Tuple[int, ...] = (64, 128, 256, 512, 800)
    caption_buckets: Tuple[int, ...] = (32, 64)
    prefetch_batches: int = 2
    beam_width: int = 1
    length_penalty: float = 0.0
    auto_resume: bool = False
    # the production setting: encoder attention sites that qualify run the
    # flash kernel
    use_pallas_attention: bool = True
    num_data_workers: int = 8
    eval_max_batches: Optional[int] = None
    debug_nans: bool = False
    profile_dir: Optional[str] = None
    rl_pipeline: bool = True

    def __post_init__(self):
        self.curr_time = strftime("%y%m%d%H%M%S", localtime())
        # global batch = per-device B x data devices
        self.train_batch_size = self.B * self.num_data_devices()
        if self.to_log:
            base = os.path.join(self.log_dir, self.procedure)
            self.log_path = os.path.join(base, self.curr_time[2:])
            self.model_checkpoint_path = self.log_path
        else:
            self.log_path = self.model_checkpoint_path = None

    def agent_kwargs(self, voc_size: int) -> Dict:
        """``BMHrlAgent`` arguments of this configuration."""
        return dict(voc_size=voc_size, d_video=self.d_vid,
                    d_audio=self.d_aud, d_ff_v=self.rl_ff_v,
                    d_ff_a=self.rl_ff_a, d_ff_c=self.rl_ff_c,
                    **self._shared_kwargs())

    def unimodal_kwargs(self, voc_size: int, modality: str) -> Dict:
        """``UnimodalAgent`` arguments of one modality, "audio" (AHRL) or
        "video" (VHRL), as the JAX package's ``AudioAgent.build`` and
        ``VideoAgent.build`` set them."""
        audio = modality == "audio"
        return dict(voc_size=voc_size, modality=modality,
                    d_m1=self.d_aud if audio else self.d_vid,
                    d_ff_m1=self.rl_ff_a if audio else self.rl_ff_v,
                    **self._shared_kwargs())

    def _shared_kwargs(self) -> Dict:
        import torch

        return dict(d_model=self.d_model, d_model_caps=self.d_model_caps,
                    att_heads=self.rl_att_heads,
                    att_layers=self.rl_att_layers, dout_p=self.dout_p,
                    d_goal=self.rl_goal_d,
                    critic_score_threshold=self.rl_critic_score_threshhold,
                    dtype=getattr(torch, self.compute_dtype),
                    use_flash=self.use_pallas_attention)

    @property
    def inference_batch_size(self) -> int:
        """The global serving batch: ``inf_B_coeff`` x ``train_batch_size``."""
        return self.inf_B_coeff * self.train_batch_size

    def num_data_devices(self) -> int:
        """The data axis of ``mesh_shape``: d, or for d <= 0 every CUDA
        device (over the model axis; 1 without a card)."""
        d, m = self.mesh_shape
        if d <= 0:
            import torch

            n = torch.cuda.device_count() if torch.cuda.is_available() else 1
            d = max(1, n // max(1, m))
        return d

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)
