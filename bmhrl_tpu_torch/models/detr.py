"""The DETR-style captioner (``--mode DETR``; the port of
bmhrl_tpu/models/detr.py): stacked temporal Conv1d + GroupNorm projections
of the video features, a post-norm encoder over them, a mini-DETR word-set
detector (``ObjectDetect``) whose decoder states feed the caption decoder's
object attention, and the caption decoder with its vocabulary head.

The reference's quirks are kept: in the decoder layer the LayerNorm comes
before the self-attention residual add, the memory and object attentions
take the pre-self-attention queries, the object mask is dropped, and EOS
becomes PAD in the caption input. ``pre_goal_attention`` turns on the
goal-fusion path (a manager decoder, the frozen critic's labels with the
first end token forced to a boundary, the Manager's goals, goal and
goal-feature attention into a widened worker stream).

Module and parameter names follow the flax tree, so
``weights.load_jax_params`` maps them by rule; flax creates no parameters
for what its ``init`` never calls, and neither does the port: the critic
exists only with ``pre_goal_attention``, the decoder's object attention
only where objects are given, and the decoder's goal attention (never
given a goal by any caller) not at all.

Decode: the full-buffer loop (``decode_frontier``, every decode mode and
the only one of ``pre_goal_attention``) and, on the default path, the
fast incremental loop (``init_decode_caches``, ``precompute_decode_mem``,
``decode_step``): KV-cached self-attention, the memory cross-attention on
keys/values projected once per clip, and the object attention folded onto
the raw object embeddings through ``ops.attention.folded_attend`` (one
call per layer; beams of a clip join its query groups). The critic hooks
are stubs that give no boundary, as in the reference's executed path.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch
from torch import nn

from bmhrl_tpu_torch import resolve_device
from bmhrl_tpu_torch.models.attention import MultiheadedAttention
from bmhrl_tpu_torch.models.blocks import (ConvSame, Dense, Draws,
                                           PositionalEncoder,
                                           VocabularyEmbedder, dropout)
from bmhrl_tpu_torch.models.bmhrl import Manager
from bmhrl_tpu_torch.models.critic import SegmentCritic
from bmhrl_tpu_torch.ops import attention as fused

PAD, EOS = 1, 3
NEG_INF = -1e9


def _ln(norm: nn.LayerNorm, x: torch.Tensor, dtype) -> torch.Tensor:
    """flax ``LayerNorm`` in f32, cast back to the compute dtype."""
    return norm(x.float()).to(dtype)


class GroupNorm(nn.GroupNorm):
    """flax ``nn.GroupNorm(num_groups, epsilon)`` on (B, L, C), f32: the
    statistics of each group over positions and its channels, the variance
    as E[x²] - E[x]² clipped at 0 (flax's)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, L, C = x.shape
        g = x.float().reshape(B, L, self.num_groups, C // self.num_groups)
        mean = g.mean(dim=(1, 3), keepdim=True)
        var = ((g * g).mean(dim=(1, 3), keepdim=True)
               - mean * mean).clamp_min(0.0)
        y = ((g - mean) * torch.rsqrt(var + self.eps)).reshape(B, L, C)
        return y * self.weight + self.bias


class DetrEncoderLayer(nn.Module):
    """Post-norm encoder layer; Q and K carry position, V does not, so the
    three projections run separately (flash on the card where the site
    qualifies)."""

    def __init__(self, d_model, nhead, dim_ff, dout_p, dtype, use_flash,
                 device):
        super().__init__()
        self.dtype, self.dout_p = dtype, dout_p
        self.self_attn = MultiheadedAttention(
            d_model, d_model, d_model, nhead, d_model, dtype=dtype,
            use_flash=use_flash, device=device, dout_p=dout_p)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5, device=device)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5, device=device)
        self.linear1 = Dense(d_model, dim_ff, dtype, device)
        self.linear2 = Dense(dim_ff, d_model, dtype, device)

    def forward(self, src, mask, pos_enc, draws=None):
        p, dt = self.dout_p, self.dtype
        q = pos_enc(src, draws)
        src = src + dropout(self.self_attn(q, q, src, mask, draws), p, draws)
        src = _ln(self.norm1, src, dt)
        h = dropout(torch.relu(self.linear1(src)), p, draws)
        src = src + dropout(self.linear2(h), p, draws)
        return _ln(self.norm2, src, dt)


class DetrEncoder(nn.Module):
    def __init__(self, d_model, nhead, dim_ff, dout_p, num_layers, dtype,
                 use_flash, device):
        super().__init__()
        self.num_layers, self.dtype = num_layers, dtype
        for i in range(num_layers):
            self.add_module(f"layer_{i}", DetrEncoderLayer(
                d_model, nhead, dim_ff, dout_p, dtype, use_flash, device))
        self.norm = nn.LayerNorm(d_model, eps=1e-5, device=device)

    def forward(self, src, mask, pos_enc, draws=None):
        for i in range(self.num_layers):
            src = getattr(self, f"layer_{i}")(src, mask, pos_enc, draws)
        return _ln(self.norm, src, self.dtype)


class DetrDecoderLayer(nn.Module):
    """Caption (or query) decoder layer with the reference's orders; the
    object attention and its norm exist when ``with_objects``."""

    def __init__(self, d_model, nhead, d_model_C, dim_ff, dout_p, dtype,
                 use_flash, device, with_objects: bool = False,
                 d_obj: int = 256):
        super().__init__()
        self.dtype, self.dout_p = dtype, dout_p
        att = dict(d_model=d_model, dtype=dtype, use_flash=use_flash,
                   device=device, dout_p=dout_p)
        self.self_attn = MultiheadedAttention(d_model_C, d_model_C,
                                              d_model_C, nhead, **att)
        self.multihead_attn = MultiheadedAttention(d_model_C, d_model,
                                                   d_model, nhead, **att)
        if with_objects:
            self.detected_attention = MultiheadedAttention(
                d_model_C, d_obj, d_obj, nhead, **att)
        for i in (1, 2, 3) + ((5,) if with_objects else ()):
            self.add_module(f"norm{i}",
                            nn.LayerNorm(d_model_C, eps=1e-5, device=device))
        self.linear1 = Dense(d_model_C, dim_ff, dtype, device)
        self.linear2 = Dense(dim_ff, d_model_C, dtype, device)

    def _ffn(self, tgt, draws=None):
        p = self.dout_p
        h = dropout(torch.relu(self.linear1(tgt)), p, draws)
        tgt = tgt + dropout(self.linear2(h), p, draws)
        return _ln(self.norm3, tgt, self.dtype)

    def forward(self, tgt, memory, memory_mask, pos_enc, query_pos_enc,
                query_mask, add_pos=None, detected_objects=None, draws=None,
                mem_kv=None, obj_kv=None):
        """``add_pos`` (the detector's query positions) makes the
        self-attention non-causal over q = tgt + add_pos; without it the
        queries are ``query_pos_enc(tgt)`` under a causal ``query_mask``.
        ``mem_kv``/``obj_kv``: the memory's / objects' projected keys and
        values (``project_kv``), a decode's per-clip constants."""
        p, dt = self.dout_p, self.dtype
        if add_pos is None:
            q, causal = query_pos_enc(tgt, draws), True
        else:
            q, causal = tgt + add_pos, False
        tgt2 = self.self_attn(q, q, tgt, query_mask, draws, causal=causal)
        tgt = _ln(self.norm1, tgt, dt) + dropout(tgt2, p, draws)
        if mem_kv is not None:
            tgt2 = self.multihead_attn(q, None, None, memory_mask, draws,
                                       precomputed_kv=mem_kv)
        else:
            tgt2 = self.multihead_attn(q, pos_enc(memory, draws), memory,
                                       memory_mask, draws)
        tgt = _ln(self.norm2, tgt + dropout(tgt2, p, draws), dt)
        if detected_objects is not None or obj_kv is not None:
            tgt2 = self.detected_attention(q, detected_objects,
                                           detected_objects, None, draws,
                                           precomputed_kv=obj_kv)
            tgt = _ln(self.norm5, tgt + dropout(tgt2, p, draws), dt)
        return self._ffn(tgt, draws)

    def step_weights(self) -> Dict:
        return {"obj": self.detected_attention.folded_weights()}

    def step(self, tgt_t, t: torch.Tensor, cache, memory_mask, kv_mem,
             obj_mem, pe_row, key_mask, sw, beam_share: int = 1):
        """One position of the caption path: tgt_t (R, 1, Dc) the raw
        stream, t a 0-d int64 tensor, pe_row (1, 1, Dc) row t of the
        positional table. Self-attention from the KV cache (written in
        place), cross-attention on
        the clip's projected memory ``kv_mem``, the object attention folded
        onto the raw objects ``obj_mem`` (B, 100, d_obj) with ``sw``'s
        weights (``step_weights``), the feed-forward. ``beam_share`` = W:
        R = B x W rows, clip-major, against clip-level memories."""
        dt = self.dtype
        q_t = (tgt_t + pe_row).to(dt)
        tgt2 = self.self_attn.attend_step_qkv(q_t, q_t, tgt_t, cache["k"],
                                              cache["v"], t, key_mask)
        tgt = _ln(self.norm1, tgt_t, dt) + tgt2.to(dt)
        R = q_t.shape[0]
        clips = R // beam_share
        q_c = q_t.reshape(clips, beam_share, -1)  # a clip's beams as queries
        tgt2 = self.multihead_attn(q_c, None, None, memory_mask,
                                   precomputed_kv=kv_mem)
        tgt = _ln(self.norm2, tgt + tgt2.reshape(R, 1, -1).to(dt), dt)
        att = self.detected_attention
        q_eff = att.folded_q(q_t, sw["obj"])  # (R, H, d_obj)
        ctx = fused.folded_attend(
            q_eff.reshape(clips, beam_share * att.H, -1), obj_mem, None,
            1.0 / math.sqrt(att.d_k))
        out = att.folded_out(ctx.reshape(R, att.H, -1), sw["obj"])
        tgt = _ln(self.norm5, tgt + out[:, None, :].to(dt), dt)
        return self._ffn(tgt)


class DetrDecoder(nn.Module):
    def __init__(self, d_model, nhead, d_model_C, dim_ff, dout_p, num_layers,
                 dtype, use_flash, device, with_objects: bool = False):
        super().__init__()
        self.num_layers, self.dtype = num_layers, dtype
        for i in range(num_layers):
            self.add_module(f"layer_{i}", DetrDecoderLayer(
                d_model, nhead, d_model_C, dim_ff, dout_p, dtype, use_flash,
                device, with_objects))
        self.norm = nn.LayerNorm(d_model_C, eps=1e-5, device=device)

    def layer(self, i: int) -> DetrDecoderLayer:
        return getattr(self, f"layer_{i}")

    def forward(self, tgt, memory, memory_mask, pos_enc, query_pos_enc,
                query_mask, add_pos=None, detected_objects=None, draws=None,
                mem_kv=None, obj_kv=None):
        for i in range(self.num_layers):
            tgt = self.layer(i)(
                tgt, memory, memory_mask, pos_enc, query_pos_enc, query_mask,
                add_pos, detected_objects, draws,
                None if mem_kv is None else mem_kv[i],
                None if obj_kv is None else obj_kv[i])
        return _ln(self.norm, tgt, self.dtype)

    def precompute_mem_kv(self, memory, pos_enc: PositionalEncoder) -> List:
        """Each layer's cross-attention keys/values of the memory: K from
        the memory position-encoded by ``pos_enc`` (no dropout), V from the
        raw one."""
        mem_pe = pos_enc(memory)
        return [self.layer(i).multihead_attn.project_kv(mem_pe, memory)
                for i in range(self.num_layers)]

    def precompute_obj_kv(self, objs) -> List:
        """Each layer's object-attention keys/values of the raw objects."""
        return [self.layer(i).detected_attention.project_kv(objs, objs)
                for i in range(self.num_layers)]


class ObjectDetect(nn.Module):
    """The mini-DETR word-set detector: width 256, 6 encoder and 6 decoder
    layers of feed-forward 2048, 100 learned queries, a class head over the
    vocabulary plus a "no word" class."""

    HIDDEN, QUERIES, LAYERS, HEADS, FF = 256, 100, 6, 4, 2048

    def __init__(self, voc_size, d_model, dout_p, dtype, use_flash, device):
        super().__init__()
        h = self.HIDDEN
        self.dtype = dtype
        self.input_projection = Dense(d_model, h, dtype, device)
        self.pos_enc = PositionalEncoder(h, dout_p, device)
        self.encoder = DetrEncoder(h, self.HEADS, self.FF, dout_p,
                                   self.LAYERS, dtype, use_flash, device)
        self.query_embed = nn.Parameter(torch.zeros(self.QUERIES, h,
                                                    device=device))
        self.decoder = DetrDecoder(h, self.HEADS, h, self.FF, dout_p,
                                   self.LAYERS, dtype, use_flash, device)
        self.class_embed = Dense(h, voc_size + 1, torch.float32, device)

    def forward(self, samples, mask, draws=None):
        """-> (class logits (B, 100, voc+1) f32, decoder states (B, 100,
        256) detached)."""
        x = self.input_projection(samples)
        memory = self.encoder(x, mask, self.pos_enc, draws)
        qp = self.query_embed[None].expand(samples.shape[0], -1, -1).to(
            self.dtype)
        hs = self.decoder(torch.zeros_like(qp), memory, mask, self.pos_enc,
                          self.pos_enc, None, add_pos=qp, draws=draws)
        return self.class_embed(hs.float()), hs.detach()


class DetrCaption(nn.Module):
    """The DETR captioner. Defaults are the flagship's (``build``): d_model
    1024, d_caps 300, d_goal 64, 4 heads, 3 encoder and decoder layers,
    ``n_time`` 3 temporal projections, feed-forward 2048, bf16 compute.
    ``d_video``: the video feature width (I3D, 1024). ``mesh``: the
    data-parallel mesh the decode loops stop over (None: one process)."""

    mesh = None

    def __init__(self, voc_size: int, d_model: int = 1024,
                 d_model_caps: int = 300, d_goal: int = 64, nhead: int = 4,
                 num_layers: int = 3, n_time: int = 3, dim_ff: int = 2048,
                 dout_p: float = 0.1, critic_score_threshold: float = 0.25,
                 pre_goal_attention: bool = False, d_video: int = 1024,
                 dtype: torch.dtype = torch.bfloat16, use_flash: bool = True,
                 device="cuda"):
        super().__init__()
        if torch.device(device).type != "meta":
            device = resolve_device(device)
        self.voc_size, self.d_model = voc_size, d_model
        self.d_model_caps, self.d_goal = d_model_caps, d_goal
        self.nhead, self.num_layers, self.n_time = nhead, num_layers, n_time
        self.dout_p = dout_p
        self.critic_score_threshold = critic_score_threshold
        self.pre_goal_attention = pre_goal_attention
        self.dtype = dtype
        self.pos_enc = PositionalEncoder(d_model, dout_p, device)
        self.pos_enc_C = PositionalEncoder(d_model_caps, dout_p, device)
        self.emb_C = VocabularyEmbedder(voc_size, d_model_caps, device)
        for i in range(n_time):
            self.add_module(f"input_proj_{i}", ConvSame(
                d_video if i == 0 else d_model, d_model, 3 * (i + 1), dtype,
                device, torch_bias_init=True))
            self.add_module(f"input_norm_{i}", GroupNorm(
                32, d_model, eps=1e-5, device=device))
        self.encoder = DetrEncoder(d_model, nhead, dim_ff, dout_p,
                                   num_layers, dtype, use_flash, device)
        self.object_detector = ObjectDetect(voc_size, d_model, dout_p, dtype,
                                            use_flash, device)
        d_worker = d_model_caps + (d_goal if pre_goal_attention else 0)
        self.worker_decoder = DetrDecoder(
            d_model, nhead, d_worker, dim_ff, dout_p, num_layers, dtype,
            use_flash, device, with_objects=True)
        self.linear = Dense(d_worker, voc_size, torch.float32, device)
        if pre_goal_attention:
            self.critic = SegmentCritic(d_model_caps, device)
            self.manager_decoder = DetrDecoder(
                d_model, nhead, d_model_caps, dim_ff, dout_p, num_layers,
                dtype, use_flash, device)
            self.manager = Manager(d_model_caps, d_goal, device, dout_p)
            self.pos_enc_goal = PositionalEncoder(d_goal, dout_p, device)
            self.pos_enc_concat = PositionalEncoder(d_worker, dout_p, device)
            att = dict(d_model=d_model, dtype=dtype, use_flash=use_flash,
                       device=device, dout_p=dout_p)
            self.goal_attention = MultiheadedAttention(
                d_model_caps, d_goal, d_goal, nhead, **att)
            self.goal_feature_attention = MultiheadedAttention(
                d_goal, d_model_caps, d_model_caps, nhead, **att)
            self.goal_norm = nn.LayerNorm(d_model_caps, eps=1e-5,
                                          device=device)

    @property
    def device(self) -> torch.device:
        return self.emb_C.embedding.weight.device

    @staticmethod
    def build(cfg, voc_size: int, device="cuda") -> "DetrCaption":
        """The configuration's DETR (the JAX package's ``build``)."""
        return DetrCaption(
            voc_size=voc_size, d_model=cfg.d_model,
            d_model_caps=cfg.d_model_caps, d_goal=cfg.rl_goal_d,
            nhead=cfg.rl_att_heads, dout_p=cfg.dout_p,
            critic_score_threshold=cfg.rl_critic_score_threshhold,
            pre_goal_attention=cfg.pre_goal_attention, d_video=cfg.d_vid,
            dtype=getattr(torch, cfg.compute_dtype),
            use_flash=cfg.use_pallas_attention, device=device)

    # -- pieces --------------------------------------------------------------
    def project_video(self, V: torch.Tensor) -> torch.Tensor:
        vf = V.to(self.dtype)
        for i in range(self.n_time):
            vf = getattr(self, f"input_proj_{i}")(vf)
            vf = getattr(self, f"input_norm_{i}")(vf).to(self.dtype)
        return vf

    def encode(self, V, A, masks, draws: Optional[Draws] = None):
        """(encoded memory, detected-object embeddings), the decode loops'
        (Va, Av) slots; A is not used."""
        vf = self.project_video(V)
        _, hs_obj = self.object_detector(vf, masks["V_mask"], draws)
        return self.encoder(vf, masks["V_mask"], self.pos_enc, draws), hs_obj

    def _forced_segment_labels(self, trg, C):
        """The critic's labels with the first end token (EOS, already PAD)
        forced to a boundary and everything after it zeroed."""
        labels = (torch.sigmoid(self.critic(C))[..., 0]
                  > self.critic_score_threshold).to(torch.int32)
        L = trg.shape[1]
        first_end = L - 1 - (trg == PAD).sum(-1)
        pos = torch.arange(L, device=trg.device)[None, :]
        labels = torch.where(pos == first_end[:, None], 1, labels)
        return torch.where(pos > first_end[:, None], 0, labels).to(
            torch.int32)

    def caption_features(self, C, trg, memory, hs_obj, masks,
                         exploration: bool = False,
                         draws: Optional[Draws] = None,
                         fusion_kv: Optional[Dict] = None,
                         noise: Optional[Draws] = None, seg=None,
                         fed=None):
        """Worker-decoder features (B, L, d_worker) of the caption
        embeddings C (B, L, Dc) of ``trg`` (EOS already PAD). ``draws``:
        the dropout draws of a training forward (None: none); ``noise``:
        the Manager's exploration normals (pre-goal path). The pre-goal
        path's segment labels are ``seg`` where given (else labelled here:
        ``_forced_segment_labels``) and its goals' cross-rank flags ``fed``
        (None: exchanged over the mesh)."""
        dt, fkv = self.dtype, fusion_kv or {}
        if self.pre_goal_attention:
            ctx = self.manager_decoder(
                C.to(dt), memory, masks["V_mask"], self.pos_enc,
                self.pos_enc_C, masks["C_mask"], draws=draws,
                mem_kv=fkv.get("manager_mem"))
            labels = (self._forced_segment_labels(trg, C) if seg is None
                      else seg)
            goals = self.manager(ctx.float(), labels, exploration, draws,
                                 noise, fed)
            gfa = self.goal_feature_attention(
                self.pos_enc_goal(goals.to(dt), draws),
                self.pos_enc_C(C, draws).to(dt), C.to(dt), masks["C_mask"],
                draws)
            tgt2 = self.goal_attention(
                self.pos_enc_C(C, draws).to(dt),
                self.pos_enc_goal(goals.to(dt), draws), goals.to(dt),
                masks["C_mask"], draws)
            C = C + dropout(tgt2.to(C.dtype), self.dout_p, draws)
            C = self.goal_norm(C.float())
            C = torch.cat([C.to(dt), gfa.to(dt)], dim=-1)
            query_pe = self.pos_enc_concat
        else:
            query_pe = self.pos_enc_C
        return self.worker_decoder(
            C.to(dt), memory, masks["V_mask"], self.pos_enc, query_pe,
            masks["C_mask"], detected_objects=hs_obj, draws=draws,
            mem_kv=fkv.get("worker_mem"), obj_kv=fkv.get("worker_obj"))

    def _caption_input(self, trg):
        """Token ids with EOS as PAD (the reference's input quirk)."""
        return torch.where(trg == EOS, PAD, trg)

    def forward(self, V, A, trg, masks, mix_factor=None,
                exploration: bool = False, deterministic: bool = True,
                draws: Optional[Draws] = None):
        """Teacher-forced forward (the bimodal agent's signature; A is not
        used; ``mix_factor`` is accepted and, as in the reference, unused).
        Returns (log-probs (B, L, V), worker features [..., :d_caps],
        memory, zero goals (B, L, d_goal), zero segments (B, L), the
        detector's class logits (B, 100, voc+1))."""
        if (exploration or not deterministic) and draws is None:
            raise ValueError("a forward with dropout or exploration needs "
                             "draws")
        drop = None if deterministic else draws
        vf = self.project_video(V)
        classes, hs_obj = self.object_detector(vf, masks["V_mask"], drop)
        memory = self.encoder(vf, masks["V_mask"], self.pos_enc, drop)
        trg = self._caption_input(trg)
        wf = self.caption_features(self.emb_C(trg), trg, memory, hs_obj,
                                   masks, exploration, drop, noise=draws)
        pred = torch.log_softmax(self.linear(wf.float()), dim=-1)
        B, L = trg.shape
        dev = trg.device
        return (pred, wf[:, :, : self.d_model_caps], memory,
                torch.zeros(B, L, self.d_goal, device=dev),
                torch.zeros(B, L, dtype=torch.int32, device=dev), classes)

    # -- the full-buffer decode ------------------------------------------------
    def critic_step_weights(self):
        return None

    def critic_init_state(self, B: int):
        return torch.zeros(B, device=self.device)

    def critic_step(self, tok_t, state, crit_w=None):
        """Stub of the executed path: no segment boundary ever."""
        return torch.full(tok_t.shape, NEG_INF, device=tok_t.device), state

    def precompute_fusion_kv(self, Va, Av) -> Dict:
        """The decoders' memory keys/values and the worker's object
        keys/values, once per decode (Va the memory, Av the objects)."""
        kv = {"worker_mem": self.worker_decoder.precompute_mem_kv(
                  Va, self.pos_enc),
              "worker_obj": self.worker_decoder.precompute_obj_kv(Av)}
        if self.pre_goal_attention:
            kv["manager_mem"] = self.manager_decoder.precompute_mem_kv(
                Va, self.pos_enc)
        return kv

    def frontier_head(self, trg, labels):
        """The full-buffer token's input to its cross-row rule: on the
        pre-goal path (seg,) the buffer's segment labels
        (``_forced_segment_labels``) and their rows' boundary flags, which
        the ranks exchange for the Manager's goal expansion; else nothing
        and None (no cross-row rule). ``labels`` (the stub critic's) are
        not used."""
        if not self.pre_goal_attention:
            return (), None
        trg = self._caption_input(trg)
        seg = self._forced_segment_labels(trg, self.emb_C(trg))
        return (seg,), seg.bool().any(dim=1)

    def decode_frontier(self, trg, labels, Va, Av, masks, t: torch.Tensor,
                        exploration: bool = False,
                        fusion_kv: Optional[Dict] = None,
                        draws: Optional[Draws] = None, head=None, fed=None):
        """Log-probs (B, V) at position t of the buffer trg (B, L): the
        decoders over the whole buffer, the vocabulary projection at t.
        ``labels`` (the stub critic's) are not used; the pre-goal path
        labels the buffer with its own critic, or takes ``head``
        (``frontier_head``'s), and expands its goals under the cross-rank
        flags ``fed`` (None: exchanged over the mesh)."""
        trg = self._caption_input(trg)
        wf = self.caption_features(self.emb_C(trg), trg, Va, Av, masks,
                                   exploration, None, fusion_kv, draws,
                                   seg=head[0] if head else None, fed=fed)
        wf_t = wf.index_select(1, t.reshape(1))[:, 0]
        return torch.log_softmax(self.linear(wf_t.float()), dim=-1)

    @property
    def cross_row_step(self) -> bool:
        """Does a token's step hold a cross-row rule besides the loop's
        stop? Only the pre-goal path's (its goal expansion);
        ``serve_export`` exports the default path's step whole."""
        return self.pre_goal_attention

    # -- the fast decode (default path) ---------------------------------------
    @property
    def has_fast_loop(self) -> bool:
        """The pre-goal path has none: its labels change behind the
        frontier."""
        return not self.pre_goal_attention

    def fast_state(self, Va, Av, masks_src, B: int, L: int):
        """The fast loop's start, as ``HierarchicalAgent.fast_state``:
        (caches0, valid0, inv) with ``inv`` the memory's keys/values
        projected once, the object attention's folded weights, the raw
        objects and the memory mask, all at clip level (Va the encoded
        memory, Av the detected objects)."""
        caches0 = self.init_decode_caches(B, L)
        inv = {"kv_mem": self.precompute_decode_mem(Va),
               "sw": self.step_weights(), "objs": Av.contiguous(),
               "mask": masks_src["V_mask"]}
        valid0 = torch.zeros(B, L, dtype=torch.bool, device=Va.device)
        valid0[:, 0] = True
        return caches0, valid0, inv

    def fast_step(self, tok_t, t: torch.Tensor, caches, valid, inv,
                  beam_share: int = 1):
        """One token (t a 0-d int64 tensor), as
        ``HierarchicalAgent.fast_step``: the caches are written in place and
        returned. The object attention is folded onto the raw objects (one
        ``folded_attend`` per layer, the W beams of a clip in its query
        groups)."""
        return self.decode_step(tok_t, t, caches, inv["mask"], inv["kv_mem"],
                                inv["objs"], valid, inv["sw"],
                                beam_share), caches

    def fast_setup(self, Va, Av, masks_src, B: int, L: int,
                   beam_share: int = 1):
        """The fast loop's state and per-token step, as
        ``HierarchicalAgent.fast_setup``."""
        caches0, valid0, inv = self.fast_state(Va, Av, masks_src, B, L)

        def step_fn(tok_t, t, caches, valid):
            return self.fast_step(tok_t, t, caches, valid, inv, beam_share)

        return caches0, valid0, step_fn

    def init_decode_caches(self, B: int, L: int) -> Dict:
        H = self.nhead
        dk = self.d_model // H
        dev = self.device
        return {"dec": [{"k": torch.zeros(B, H, L, dk, device=dev),
                         "v": torch.zeros(B, H, L, dk, device=dev)}
                        for _ in range(self.num_layers)]}

    def precompute_decode_mem(self, memory) -> List:
        return self.worker_decoder.precompute_mem_kv(memory, self.pos_enc)

    def step_weights(self) -> List[Dict]:
        return [self.worker_decoder.layer(i).step_weights()
                for i in range(self.num_layers)]

    def decode_step(self, tok_t, t: torch.Tensor, caches, memory_mask,
                    kv_mem, hs_obj, key_mask, sw, beam_share: int = 1):
        """One token at position t (a 0-d int64 tensor): EOS -> PAD, embed,
        the decoder stack's step (caches written in place), final norm,
        vocabulary head. Returns (R, V) log-probs. ``memory_mask`` (B, 1,
        S) and ``hs_obj`` are per clip; ``sw``: ``step_weights()``."""
        dt = self.dtype
        x = self.emb_C(self._caption_input(tok_t)[:, None]).to(dt)
        pe_row = self.pos_enc_C.table.index_select(0, t.reshape(1))[None].to(
            dt)
        dec = self.worker_decoder
        for i in range(self.num_layers):
            x = dec.layer(i).step(x, t, caches["dec"][i], memory_mask,
                                  kv_mem[i], hs_obj, pe_row, key_mask, sw[i],
                                  beam_share)
        x = _ln(dec.norm, x, dt)
        return torch.log_softmax(self.linear(x.float())[:, 0], dim=-1)
