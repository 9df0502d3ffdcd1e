"""The unimodal ablation agents, AHRL (audio only) and VHRL (video only): the
port of bmhrl_tpu/models/unimodal.py.

``UnimodalAgent`` takes the bimodal agent's arguments (V, A and the masks
dict) and picks its modality, so the decode loops, the server and the
training steps drive it as they drive ``BMHrlAgent``; the two share the
critic, Manager and Worker machinery (``bmhrl.HierarchicalAgent``). Module
names follow the flax tree, the flat ``uni_enc_layer_{i}``,
``uni_worker_fus_layer_{i}`` and ``uni_manager_fus_layer_{i}`` included,
so ``weights.load_jax_params`` and ``train.steps.param_groups`` work by
rule.

In the token step, both stacks' cross-attention queries over the one
memory meet in ONE ``ops.attention.folded_attend`` per layer (G = 2 x
heads, times the beams in beam search), as in the bimodal step; the JAX
package computes the same function per stack with ``attend_folded``.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch
from torch import nn

from bmhrl_tpu_torch import resolve_device
from bmhrl_tpu_torch.models.attention import MultiheadedAttention
from bmhrl_tpu_torch.models.blocks import (Draws, PositionalEncoder,
                                           PositionwiseFeedForward,
                                           ResidualConnection,
                                           VocabularyEmbedder)
from bmhrl_tpu_torch.models.bmhrl import HierarchicalAgent, Manager, Worker
from bmhrl_tpu_torch.models.critic import SegmentCritic


class UnimodalEncoderLayer(nn.Module):
    """Self-attention and a feed-forward with prenorm residuals (the
    reference skips its middle residual slot: indices 0 and 2)."""

    def __init__(self, d_m1, d_model, d_ff, H, dtype, use_flash, device,
                 dout_p=0.0):
        super().__init__()
        self.self_att_M1 = MultiheadedAttention(
            d_m1, d_m1, d_m1, H, d_model, dtype=dtype, use_flash=use_flash,
            device=device, dout_p=dout_p)
        self.ff_M1 = PositionwiseFeedForward(d_m1, d_ff, dtype, device, dout_p)
        self.res_M1_0 = ResidualConnection(d_m1, device, dout_p)
        self.res_M1_2 = ResidualConnection(d_m1, device, dout_p)

    def forward(self, x, mask, draws=None):
        d = draws
        h = self.res_M1_0.pre(x)
        x = self.res_M1_0.post(x, self.self_att_M1(h, h, h, mask, d), d)
        return self.res_M1_2.post(x, self.ff_M1(self.res_M1_2.pre(x), d), d)


class UnimodalFusionLayer(nn.Module):
    """Caption decoder layer: causal self-attention, cross-attention into
    the modality's memory, LayerNorm; over a whole caption (``forward``) or
    one position at a time with cached self-attention and folded
    cross-attention (``step_mem_pre``/``step_mem_post``)."""

    def __init__(self, d_m1, d_model_C, d_model, H, dtype, device,
                 use_flash=True, dout_p=0.0):
        super().__init__()
        att = dict(d_model=d_model, dtype=dtype, device=device,
                   use_flash=use_flash, dout_p=dout_p)
        self.dtype = dtype
        self.self_att = MultiheadedAttention(
            d_model_C, d_model_C, d_model_C, H, **att)
        self.enc_att = MultiheadedAttention(d_model_C, d_m1, d_m1, H, **att)
        self.res_self_att = ResidualConnection(d_model_C, device, dout_p)
        self.res_enc_att = ResidualConnection(d_model_C, device, dout_p)
        self.normC = nn.LayerNorm(d_model_C, eps=1e-5, device=device)

    def precompute_kv(self, memory):
        return self.enc_att.project_kv(memory, memory)

    def forward(self, C, memory, m1_mask, c_mask, draws=None, cross_kv=None):
        """C (B, L, Dc) under the caption mask ``c_mask``; ``memory`` under
        its (B, 1, S) pad mask. ``cross_kv``: ``precompute_kv(memory)``."""
        d = draws
        h = self.res_self_att.pre(C)
        C = self.res_self_att.post(C, self.self_att(h, h, h, c_mask, d), d)
        Cm = self.res_enc_att.post(C, self.enc_att(
            self.res_enc_att.pre(C), memory, memory, m1_mask, d, cross_kv), d)
        return self.normC(Cm.float()).to(self.dtype)

    def step_weights(self) -> Dict:
        """Loop-invariant weights of one decode (merged QKV in the compute
        dtype, the folded cross-attention projections)."""
        w, b = self.self_att.merged_qkv_params()
        return {"qkv": (w.to(self.dtype), b.to(self.dtype)),
                "mem": self.enc_att.folded_weights()}

    def step_mem_pre(self, c_t, t, cache, key_mask, sw):
        """Self-attention + residual, the pre-LN and the folded effective
        queries. Returns (C, q_eff (B, H, d_m1)); the cache is updated in
        place."""
        h = self.res_self_att.pre(c_t).to(c_t.dtype)
        out = self.self_att.attend_step_shared(
            h, cache["k"], cache["v"], t, key_mask, sw["qkv"])
        C = self.res_self_att.post(c_t, out.to(c_t.dtype))
        he = self.res_enc_att.pre(C).to(c_t.dtype)
        return C, self.enc_att.folded_q(he, sw["mem"])

    def step_mem_post(self, C, ctx, sw):
        """Folded value/output projection of the context, residual,
        LayerNorm."""
        out = self.enc_att.folded_out(ctx, sw["mem"])[:, None, :]
        Cm = self.res_enc_att.post(C, out.to(C.dtype))
        return self.normC(Cm.float()).to(self.dtype)


class UnimodalAgent(HierarchicalAgent):
    """Single-modality hierarchical captioner over ``modality`` "audio"
    (AHRL: d_m1 = d_aud) or "video" (VHRL: d_m1 = d_vid). Parameters are
    f32 on ``device`` ("cuda" by default; "cpu" runs the kernels' plain
    versions; "meta" builds shapes only)."""

    # flat module-name prefixes of the two identically shaped fusion stacks
    UNI_FUSION_PARAM_PREFIXES = ("uni_worker_fus", "uni_manager_fus")

    def __init__(self, voc_size: int, d_m1: int, d_ff_m1: int, modality: str,
                 d_model: int = 1024, d_model_caps: int = 300,
                 att_heads: int = 4, att_layers: int = 2, dout_p: float = 0.1,
                 d_goal: int = 64, critic_score_threshold: float = 0.25,
                 dtype: torch.dtype = torch.bfloat16, use_flash: bool = True,
                 device="cuda"):
        super().__init__()
        if modality not in ("audio", "video"):
            raise ValueError(f"modality must be 'audio' or 'video', got "
                             f"{modality!r}")
        if torch.device(device).type != "meta":
            device = resolve_device(device)
        self.voc_size = voc_size
        self.modality = modality
        self.d_model = d_model
        self.d_model_caps = d_model_caps
        self.att_heads = att_heads
        self.att_layers = att_layers
        self.critic_score_threshold = critic_score_threshold
        self.dtype = dtype
        self.pos_enc = PositionalEncoder(d_m1, dout_p, device)
        self.pos_enc_C = PositionalEncoder(d_model_caps, dout_p, device)
        self.critic = SegmentCritic(d_model_caps, device)
        self.emb_C = VocabularyEmbedder(voc_size, d_model_caps, device)
        for i in range(att_layers):
            self.add_module(f"uni_enc_layer_{i}", UnimodalEncoderLayer(
                d_m1, d_model, d_ff_m1, att_heads, dtype, use_flash, device,
                dout_p))
        for prefix in self.UNI_FUSION_PARAM_PREFIXES:
            for i in range(att_layers):
                self.add_module(f"{prefix}_layer_{i}", UnimodalFusionLayer(
                    d_m1, d_model_caps, d_model, att_heads, dtype, device,
                    use_flash, dout_p))
        self.manager = Manager(d_model_caps, d_goal, device, dout_p)
        self.worker = Worker(voc_size, d_model_caps, d_goal, d_model, dtype,
                             device, dout_p)

    def _mask_key(self) -> str:
        return "A_mask" if self.modality == "audio" else "V_mask"

    def encode(self, V, A, masks, draws: Optional[Draws] = None):
        """The modality's features -> its memory, returned in both slots
        (Va, Av), as the JAX agent does. ``draws``: dropout draws."""
        m1 = A if self.modality == "audio" else V
        m1 = self.pos_enc(m1.to(self.dtype), draws)
        for i in range(self.att_layers):
            m1 = getattr(self, f"uni_enc_layer_{i}")(
                m1, masks[self._mask_key()], draws)
        return m1, m1

    def fusion_layer(self, s: int, i: int) -> UnimodalFusionLayer:
        return getattr(self, f"{self.UNI_FUSION_PARAM_PREFIXES[s]}_layer_{i}")

    def fusion_features(self, C, Va, Av, masks, drop=None,
                        fusion_kv: Optional[Dict] = None):
        """(worker, manager) features of the caption C over the memory Va
        (= Av); ``fusion_kv``: ``precompute_fusion_kv`` (None: project
        here)."""
        m1_mask = masks[self._mask_key()]
        feats = []
        for s, stack in enumerate(("worker", "manager")):
            x = C
            for i in range(self.att_layers):
                kv = None if fusion_kv is None else fusion_kv[stack][i]
                x = self.fusion_layer(s, i)(x, Va, m1_mask, masks["C_mask"],
                                            drop, kv)
            feats.append(x)
        return feats[0], feats[1]

    def precompute_fusion_kv(self, Va, Av) -> Dict:
        """Both stacks' cross-attention keys/values of the memory, once per
        decode."""
        return {stack: [self.fusion_layer(s, i).precompute_kv(Va)
                        for i in range(self.att_layers)]
                for s, stack in enumerate(("worker", "manager"))}

    def decode_memories(self, Va, Av, masks) -> List:
        return [(Va, masks[self._mask_key()][:, 0, :].to(torch.int32)
                 .contiguous())]


class AudioAgent:
    """AHRL: ``UnimodalAgent`` over the audio features."""

    @staticmethod
    def build(cfg, voc_size: int, device="cuda") -> UnimodalAgent:
        return UnimodalAgent(**cfg.unimodal_kwargs(voc_size, "audio"),
                             device=device)


class VideoAgent:
    """VHRL: ``UnimodalAgent`` over the video features (rgb + flow)."""

    @staticmethod
    def build(cfg, voc_size: int, device="cuda") -> UnimodalAgent:
        return UnimodalAgent(**cfg.unimodal_kwargs(voc_size, "video"),
                             device=device)
