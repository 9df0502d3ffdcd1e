"""BMHRL agent, serving surface: bimodal encoder, the two fusion decoder
stacks stepped one token at a time, the Manager goal step and the Worker
vocabulary head (the port of bmhrl_tpu/models/bmhrl.py).

Module and parameter names follow the JAX package's param tree
(``weights.load_jax_params`` maps one onto the other). The teacher-forced
full forward, the value functions and exploration belong to the training
path and are not ported here.
"""
from __future__ import annotations

import math
from typing import Dict

import torch
from torch import nn

from bmhrl_tpu_torch import resolve_device
from bmhrl_tpu_torch.models.attention import (FoldedWeights,
                                              MultiheadedAttention)
from bmhrl_tpu_torch.models.blocks import (Dense, PositionalEncoder,
                                           PositionwiseFeedForward,
                                           ResidualConnection,
                                           VocabularyEmbedder, rounded)
from bmhrl_tpu_torch.models.critic import SegmentCritic
from bmhrl_tpu_torch.ops.segments import frontier_goal

NEG_INF = -1e9


class BMEncoderLayer(nn.Module):
    """Self-attention per modality, symmetric cross-modal attention, then a
    feed-forward per modality; prenorm residuals."""

    def __init__(self, d_model_M1, d_model_M2, d_model, d_ff_M1, d_ff_M2, H,
                 dtype, use_flash, device):
        super().__init__()
        att = dict(d_model=d_model, dtype=dtype, use_flash=use_flash,
                   device=device)
        self.self_att_M1 = MultiheadedAttention(
            d_model_M1, d_model_M1, d_model_M1, H, **att)
        self.self_att_M2 = MultiheadedAttention(
            d_model_M2, d_model_M2, d_model_M2, H, **att)
        self.bi_modal_att_M1 = MultiheadedAttention(
            d_model_M1, d_model_M2, d_model_M2, H, **att)
        self.bi_modal_att_M2 = MultiheadedAttention(
            d_model_M2, d_model_M1, d_model_M1, H, **att)
        self.ff_M1 = PositionwiseFeedForward(d_model_M1, d_ff_M1, dtype, device)
        self.ff_M2 = PositionwiseFeedForward(d_model_M2, d_ff_M2, dtype, device)
        for i in range(3):
            self.add_module(f"res_M1_{i}",
                            ResidualConnection(d_model_M1, device))
            self.add_module(f"res_M2_{i}",
                            ResidualConnection(d_model_M2, device))

    def forward(self, M1, M2, M1_mask, M2_mask):
        h = self.res_M1_0.pre(M1)
        M1 = self.res_M1_0.post(M1, self.self_att_M1(h, h, h, M1_mask))
        h = self.res_M2_0.pre(M2)
        M2 = self.res_M2_0.post(M2, self.self_att_M2(h, h, h, M2_mask))
        M1m2 = self.res_M1_1.post(M1, self.bi_modal_att_M1(
            self.res_M1_1.pre(M1), M2, M2, M2_mask))
        M2m1 = self.res_M2_1.post(M2, self.bi_modal_att_M2(
            self.res_M2_1.pre(M2), M1, M1, M1_mask))
        M1m2 = self.res_M1_2.post(M1m2, self.ff_M1(self.res_M1_2.pre(M1m2)))
        M2m1 = self.res_M2_2.post(M2m1, self.ff_M2(self.res_M2_2.pre(M2m1)))
        return M1m2, M2m1


class BMEncoder(nn.Module):
    def __init__(self, N: int, **layer_kw):
        super().__init__()
        self.N = N
        for i in range(N):
            self.add_module(f"layer_{i}", BMEncoderLayer(**layer_kw))

    def forward(self, V, A, V_mask, A_mask):
        for i in range(self.N):
            V, A = getattr(self, f"layer_{i}")(V, A, V_mask, A_mask)
        return V, A  # (video-side memory, audio-side memory)


class BMFusionLayer(nn.Module):
    """Caption decoder layer, stepped one position at a time: cached causal
    self-attention, folded cross-attention into the audio and video
    memories, per-branch LayerNorm, sigmoid-gated A/V blend. The reference
    builds a feed-forward here that it never applies; it is omitted."""

    def __init__(self, d_model_A, d_model_V, d_model_C, d_model, H, dtype,
                 device):
        super().__init__()
        att = dict(d_model=d_model, dtype=dtype, device=device)
        self.dtype = dtype
        self.self_att = MultiheadedAttention(
            d_model_C, d_model_C, d_model_C, H, **att)
        self.enc_att_A = MultiheadedAttention(
            d_model_C, d_model_A, d_model_A, H, **att)
        self.enc_att_V = MultiheadedAttention(
            d_model_C, d_model_V, d_model_V, H, **att)
        self.res_self_att = ResidualConnection(d_model_C, device)
        self.res_enc_att_A = ResidualConnection(d_model_C, device)
        self.res_enc_att_V = ResidualConnection(d_model_C, device)
        self.normCA = nn.LayerNorm(d_model_C, eps=1e-5, device=device)
        self.normCV = nn.LayerNorm(d_model_C, eps=1e-5, device=device)
        self.a_v_constant = nn.Parameter(torch.zeros(1, device=device))

    def step_weights(self) -> Dict:
        """Loop-invariant weights of one decode (merged QKV in the compute
        dtype, folded cross-attention projections)."""
        w, b = self.self_att.merged_qkv_params()
        return {"qkv": (w.to(self.dtype), b.to(self.dtype)),
                "A": self.enc_att_A.folded_weights(),
                "V": self.enc_att_V.folded_weights()}

    def step_mem_pre(self, c_t, t, cache, key_mask, sw):
        """Self-attention + residual, branch pre-LNs and folded effective
        queries. Returns (C, q_eff_A (B, H, dA), q_eff_V (B, H, dV)); the
        cache is updated in place. The cross-attention contractions run
        outside, in one folded_attend per branch for both stacks."""
        h = self.res_self_att.pre(c_t).to(c_t.dtype)
        out = self.self_att.attend_step_shared(
            h, cache["k"], cache["v"], t, key_mask, sw["qkv"])
        C = self.res_self_att.post(c_t, out.to(c_t.dtype))
        ha = self.res_enc_att_A.pre(C).to(c_t.dtype)
        hv = self.res_enc_att_V.pre(C).to(c_t.dtype)
        return (C, self.enc_att_A.folded_q(ha, sw["A"]),
                self.enc_att_V.folded_q(hv, sw["V"]))

    def step_mem_post(self, C, ctx_a, ctx_v, sw):
        """Folded value/output projections of the branch contexts,
        residuals, per-branch LayerNorms, gated blend."""
        out_a = self.enc_att_A.folded_out(ctx_a, sw["A"])[:, None, :]
        Ca = self.res_enc_att_A.post(C, out_a.to(C.dtype))
        out_v = self.enc_att_V.folded_out(ctx_v, sw["V"])[:, None, :]
        Cv = self.res_enc_att_V.post(C, out_v.to(C.dtype))
        Ca = self.normCA(Ca.float())
        Cv = self.normCV(Cv.float())
        av = torch.sigmoid(self.a_v_constant.clamp(-2.0, 2.0))
        return (av * Cv + (1.0 - av) * Ca).to(self.dtype)


class BMFusion(nn.Module):
    def __init__(self, N: int, **layer_kw):
        super().__init__()
        self.N = N
        for i in range(N):
            self.add_module(f"layer_{i}", BMFusionLayer(**layer_kw))

    def layer(self, i: int) -> BMFusionLayer:
        return getattr(self, f"layer_{i}")


class Manager(nn.Module):
    """Goal emitter: f32 linear(d_caps -> d_goal), then the frontier goal
    expansion (no exploration noise on the serving path)."""

    def __init__(self, d_model_caps: int, d_goal: int, device):
        super().__init__()
        self.linear = Dense(d_model_caps, d_goal, torch.float32, device)

    def goal_step(self, mf_t, label_t, has_boundary):
        return frontier_goal(self.linear(mf_t.float()), label_t, has_boundary)


class Worker(nn.Module):
    """Goal-conditioned word head: 2-head goal attention over the worker
    features, concat, f32 projection to vocabulary log-probs."""

    def __init__(self, voc_size, d_in, d_goal, d_model, dtype, device):
        super().__init__()
        self.dtype = dtype
        self.goal_attention = MultiheadedAttention(
            d_goal, d_in, d_in, 2, d_model, dtype=dtype, device=device)
        self.projection = Dense(d_in + d_goal, voc_size, torch.float32, device)

    def step_raw(self, wf_t, goal_t, wf_cache, t, key_mask,
                 fw: FoldedWeights):
        """Single-position head over the RAW worker-feature cache (B, L, Dc),
        with the goal attention's K/V/out projections folded (``fw``). The
        cache holds the compute-dtype features in f32 and is written IN
        PLACE at position t."""
        att = self.goal_attention
        dt = self.dtype
        wf_cache[:, t] = wf_t[:, 0].float()
        q_eff = torch.einsum("bq,hqk->bhk", rounded(goal_t[:, 0], dt),
                             fw.w_qk) + fw.b_qk
        scores = torch.einsum("bhk,bsk->bhs", rounded(q_eff, dt),
                              wf_cache) / math.sqrt(att.d_k)
        ok = (torch.arange(wf_cache.shape[1], device=wf_t.device) <= t)[None]
        if key_mask is not None:
            ok = ok & key_mask
        probs = torch.softmax(scores.masked_fill(~ok[:, None, :], NEG_INF),
                              dim=-1)
        ctx = torch.einsum("bhs,bsk->bhk", rounded(probs, dt), wf_cache)
        gc = att.folded_out(ctx, fw)
        h = torch.cat([wf_t[:, 0], gc.to(wf_t.dtype)], dim=-1)
        return torch.log_softmax(self.projection(h.float()), dim=-1)


class BMHrlAgent(nn.Module):
    """Bimodal hierarchical captioner (serving surface). Defaults are the
    flagship's: vocabulary given, d_model 1024, 4 heads, 2 layers, d_caps
    300, bf16 compute. Parameters are f32 on ``device`` ("cuda" by default;
    "cpu" runs the kernels' plain versions; "meta" builds shapes only)."""

    def __init__(self, voc_size: int, d_video: int = 1024, d_audio: int = 128,
                 d_model: int = 1024, d_model_caps: int = 300,
                 att_heads: int = 4, att_layers: int = 2, d_goal: int = 64,
                 d_ff_v: int = 1024, d_ff_a: int = 512, d_ff_c: int = 2048,
                 critic_score_threshold: float = 0.25,
                 dtype: torch.dtype = torch.bfloat16, use_flash: bool = True,
                 device="cuda"):
        super().__init__()
        if torch.device(device).type != "meta":
            device = resolve_device(device)
        self.voc_size = voc_size
        self.d_model = d_model
        self.d_model_caps = d_model_caps
        self.att_heads = att_heads
        self.att_layers = att_layers
        self.critic_score_threshold = critic_score_threshold
        self.dtype = dtype
        # d_ff_c sizes the feed-forward the reference builds in each fusion
        # layer but never applies; kept for the JAX package's signature
        self.d_ff_c = d_ff_c
        self.pos_enc_A = PositionalEncoder(d_audio, device=device)
        self.pos_enc_V = PositionalEncoder(d_video, device=device)
        self.pos_enc_C = PositionalEncoder(d_model_caps, device=device)
        self.critic = SegmentCritic(d_model_caps, device)
        self.emb_C = VocabularyEmbedder(voc_size, d_model_caps, device)
        self.bm_enc = BMEncoder(
            att_layers, d_model_M1=d_video, d_model_M2=d_audio,
            d_model=d_model, d_ff_M1=d_ff_v, d_ff_M2=d_ff_a, H=att_heads,
            dtype=dtype, use_flash=use_flash, device=device)
        fus = dict(d_model_A=d_audio, d_model_V=d_video,
                   d_model_C=d_model_caps, d_model=d_model, H=att_heads,
                   dtype=dtype, device=device)
        self.bm_worker_fus = BMFusion(att_layers, **fus)
        self.bm_manager_fus = BMFusion(att_layers, **fus)
        self.manager = Manager(d_model_caps, d_goal, device)
        self.worker = Worker(voc_size, d_model_caps, d_goal, d_model, dtype,
                             device)

    @property
    def device(self) -> torch.device:
        return self.emb_C.embedding.weight.device

    def encode(self, V, A, masks):
        """(B, Sv, d_video), (B, Sa, d_audio) features -> (Va, Av) memories
        in the compute dtype."""
        V = self.pos_enc_V(V.to(self.dtype))
        A = self.pos_enc_A(A.to(self.dtype))
        return self.bm_enc(V, A, masks["V_mask"], masks["A_mask"])

    def init_decode_caches(self, B: int, L: int) -> Dict:
        """Per-row decode state: critic RNN state, per-stack per-layer
        self-attention KV caches (f32 storage of compute-dtype values), the
        raw worker-feature cache of the goal attention and the per-row
        "has a boundary yet" flag."""
        dev = self.device
        H, dk = self.att_heads, self.d_model // self.att_heads

        def kv():
            return {"k": torch.zeros(B, H, L, dk, device=dev),
                    "v": torch.zeros(B, H, L, dk, device=dev)}

        return {
            "critic": self.critic.init_state(B),
            "fus": [[kv() for _ in range(self.att_layers)] for _ in range(2)],
            "goal": torch.zeros(B, L, self.d_model_caps, device=dev),
            "hb": torch.zeros(B, dtype=torch.bool, device=dev),
        }

    def decode_step_head(self, tok_t, t: int, crit_state, crit_w):
        """Embed token t, advance the frozen critic one step, position-encode.
        ``crit_w``: the critic's ``step_weights()``, packed once per decode.
        Returns (c_t (B, 1, Dc) compute dtype, label_t (B,) int, state)."""
        emb_t = self.emb_C(tok_t[:, None])
        score_t, crit = self.critic.step(emb_t[:, 0], crit_state, crit_w)
        label_t = (torch.sigmoid(score_t[:, 0])
                   > self.critic_score_threshold).to(torch.int32)
        c_t = (emb_t + self.pos_enc_C.table[t]).to(self.dtype)
        return c_t, label_t, crit

    def decode_step_tail(self, wf_t, mf_t, label_t, hb, goal_cache, t: int,
                         key_mask, goal_fw: FoldedWeights):
        """Goal emission + worker head. Returns ((B, V) log-probs, hb)."""
        hb = hb | label_t.bool()
        goal_t = self.manager.goal_step(mf_t, label_t, hb)
        logits = self.worker.step_raw(wf_t, goal_t, goal_cache, t, key_mask,
                                      goal_fw)
        return logits, hb
