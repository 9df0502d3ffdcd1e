"""BMHRL agent and its two value functions (the port of
bmhrl_tpu/models/bmhrl.py): bimodal encoder, the two fusion decoder stacks,
the Manager's goals and the Worker's vocabulary head, both teacher-forced
over a whole caption (``forward``, training) and stepped one token at a
time (the decode). ``HierarchicalAgent`` holds what the bimodal agent
shares with the unimodal one (``models.unimodal``).

Module and parameter names follow the JAX package's param tree
(``weights.load_jax_params`` maps one onto the other). A training forward
takes ``deterministic=False`` and a ``blocks.Draws`` for its dropout masks
and exploration noise, where the JAX package takes rngs.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch
from torch import nn

from bmhrl_tpu_torch import resolve_device
from bmhrl_tpu_torch.models.attention import (FoldedWeights,
                                              MultiheadedAttention)
from bmhrl_tpu_torch.models.blocks import (Dense, Draws, PositionalEncoder,
                                           PositionwiseFeedForward,
                                           ResidualConnection,
                                           VocabularyEmbedder, dropout,
                                           rounded)
from bmhrl_tpu_torch.models.critic import SegmentCritic
from bmhrl_tpu_torch.ops import attention as fused
from bmhrl_tpu_torch.parallel import mesh as mesh_lib
from bmhrl_tpu_torch.ops.segments import (expand_goals,
                                          frontier_exploration_noise,
                                          frontier_goal)

NEG_INF = -1e9


class BMEncoderLayer(nn.Module):
    """Self-attention per modality, symmetric cross-modal attention, then a
    feed-forward per modality; prenorm residuals."""

    def __init__(self, d_model_M1, d_model_M2, d_model, d_ff_M1, d_ff_M2, H,
                 dtype, use_flash, device, dout_p=0.0):
        super().__init__()
        att = dict(d_model=d_model, dtype=dtype, use_flash=use_flash,
                   device=device, dout_p=dout_p)
        self.self_att_M1 = MultiheadedAttention(
            d_model_M1, d_model_M1, d_model_M1, H, **att)
        self.self_att_M2 = MultiheadedAttention(
            d_model_M2, d_model_M2, d_model_M2, H, **att)
        self.bi_modal_att_M1 = MultiheadedAttention(
            d_model_M1, d_model_M2, d_model_M2, H, **att)
        self.bi_modal_att_M2 = MultiheadedAttention(
            d_model_M2, d_model_M1, d_model_M1, H, **att)
        self.ff_M1 = PositionwiseFeedForward(d_model_M1, d_ff_M1, dtype, device,
                                             dout_p)
        self.ff_M2 = PositionwiseFeedForward(d_model_M2, d_ff_M2, dtype, device,
                                             dout_p)
        for i in range(3):
            self.add_module(f"res_M1_{i}",
                            ResidualConnection(d_model_M1, device, dout_p))
            self.add_module(f"res_M2_{i}",
                            ResidualConnection(d_model_M2, device, dout_p))

    def forward(self, M1, M2, M1_mask, M2_mask, draws=None):
        """``draws``: dropout draws of a training forward (None: none), in
        the JAX layer's order: each sublayer's, then its residual's."""
        d = draws
        h = self.res_M1_0.pre(M1)
        M1 = self.res_M1_0.post(M1, self.self_att_M1(h, h, h, M1_mask, d), d)
        h = self.res_M2_0.pre(M2)
        M2 = self.res_M2_0.post(M2, self.self_att_M2(h, h, h, M2_mask, d), d)
        M1m2 = self.res_M1_1.post(M1, self.bi_modal_att_M1(
            self.res_M1_1.pre(M1), M2, M2, M2_mask, d), d)
        M2m1 = self.res_M2_1.post(M2, self.bi_modal_att_M2(
            self.res_M2_1.pre(M2), M1, M1, M1_mask, d), d)
        M1m2 = self.res_M1_2.post(M1m2, self.ff_M1(self.res_M1_2.pre(M1m2),
                                                   d), d)
        M2m1 = self.res_M2_2.post(M2m1, self.ff_M2(self.res_M2_2.pre(M2m1),
                                                   d), d)
        return M1m2, M2m1


class BMEncoder(nn.Module):
    def __init__(self, N: int, **layer_kw):
        super().__init__()
        self.N = N
        for i in range(N):
            self.add_module(f"layer_{i}", BMEncoderLayer(**layer_kw))

    def forward(self, V, A, V_mask, A_mask, draws=None):
        for i in range(self.N):
            V, A = getattr(self, f"layer_{i}")(V, A, V_mask, A_mask, draws)
        return V, A  # (video-side memory, audio-side memory)


class BMFusionLayer(nn.Module):
    """Caption decoder layer: causal self-attention, cross-attention into
    the audio and video memories, per-branch LayerNorm, sigmoid-gated A/V
    blend; over a whole caption (``forward``) or stepped one position at a
    time with cached self-attention and folded cross-attention. The
    reference builds a feed-forward here that it never applies; it is
    omitted."""

    def __init__(self, d_model_A, d_model_V, d_model_C, d_model, H, dtype,
                 device, use_flash=True, dout_p=0.0):
        super().__init__()
        att = dict(d_model=d_model, dtype=dtype, device=device,
                   use_flash=use_flash, dout_p=dout_p)
        self.dtype = dtype
        self.self_att = MultiheadedAttention(
            d_model_C, d_model_C, d_model_C, H, **att)
        self.enc_att_A = MultiheadedAttention(
            d_model_C, d_model_A, d_model_A, H, **att)
        self.enc_att_V = MultiheadedAttention(
            d_model_C, d_model_V, d_model_V, H, **att)
        self.res_self_att = ResidualConnection(d_model_C, device, dout_p)
        self.res_enc_att_A = ResidualConnection(d_model_C, device, dout_p)
        self.res_enc_att_V = ResidualConnection(d_model_C, device, dout_p)
        self.normCA = nn.LayerNorm(d_model_C, eps=1e-5, device=device)
        self.normCV = nn.LayerNorm(d_model_C, eps=1e-5, device=device)
        self.a_v_constant = nn.Parameter(torch.zeros(1, device=device))

    def _blend(self, Ca, Cv):
        Ca = self.normCA(Ca.float())
        Cv = self.normCV(Cv.float())
        av = torch.sigmoid(self.a_v_constant.clamp(-2.0, 2.0))
        return (av * Cv + (1.0 - av) * Ca).to(self.dtype)

    def precompute_kv(self, Av, Va) -> Dict:
        """The cross-attentions' key/value projections of the memories."""
        return {"A": self.enc_att_A.project_kv(Av, Av),
                "V": self.enc_att_V.project_kv(Va, Va)}

    def forward(self, C, Av, Va, masks, draws=None, cross_kv=None):
        """Teacher-forced layer: C (B, L, Dc) under the caption mask
        ``masks["C_mask"]`` (B, L, L); Av, Va the encoder memories under
        their (B, 1, S) pad masks. ``draws``: dropout draws (None: none);
        ``cross_kv``: ``precompute_kv(Av, Va)`` (None: project here)."""
        d = draws
        kv = cross_kv or {}
        h = self.res_self_att.pre(C)
        C = self.res_self_att.post(
            C, self.self_att(h, h, h, masks["C_mask"], d), d)
        Ca = self.res_enc_att_A.post(C, self.enc_att_A(
            self.res_enc_att_A.pre(C), Av, Av, masks["A_mask"], d,
            kv.get("A")), d)
        Cv = self.res_enc_att_V.post(C, self.enc_att_V(
            self.res_enc_att_V.pre(C), Va, Va, masks["V_mask"], d,
            kv.get("V")), d)
        return self._blend(Ca, Cv)

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
        return self._blend(Ca, Cv)


class BMFusion(nn.Module):
    def __init__(self, N: int, **layer_kw):
        super().__init__()
        self.N = N
        for i in range(N):
            self.add_module(f"layer_{i}", BMFusionLayer(**layer_kw))

    def layer(self, i: int) -> BMFusionLayer:
        return getattr(self, f"layer_{i}")

    def precompute_kv(self, Av, Va) -> List[Dict]:
        return [self.layer(i).precompute_kv(Av, Va) for i in range(self.N)]

    def forward(self, C, Av, Va, masks, draws=None, cross_kv=None):
        """``cross_kv``: ``precompute_kv(Av, Va)`` (None: project here)."""
        for i in range(self.N):
            C = self.layer(i)(C, Av, Va, masks, draws,
                              None if cross_kv is None else cross_kv[i])
        return C


class Manager(nn.Module):
    """Goal emitter: f32 linear(d_caps -> d_goal) and dropout, optional
    exploration noise scaled by detached nan-statistics of the activations,
    then goal expansion over the segments (``forward``) or at the decode
    frontier (``goal_step``, no noise). ``mesh``: the data-parallel mesh
    whose global batch the expansion and the statistics take (None: the
    rows given; ``parallel.mesh.replicate`` sets it)."""

    # the noise's mean and std are the activations' over these factors
    MEAN_FACTOR = 10.0
    STD_FACTOR = 5.0
    mesh = None

    def __init__(self, d_model_caps: int, d_goal: int, device,
                 dout_p: float = 0.0):
        super().__init__()
        self.d_goal = d_goal
        self.dout_p = dout_p
        self.linear = Dense(d_model_caps, d_goal, torch.float32, device)

    def goal_step(self, mf_t, label_t, has_boundary, fed=None):
        """The goals at the decode frontier; ``fed``: the cross-rank flags
        (``ops.segments.frontier_goal``)."""
        return frontier_goal(self.linear(mf_t.float()), label_t, has_boundary,
                             self.mesh, fed)

    def forward(self, x, critic_mask, exploration: bool = False,
                drop: Optional[Draws] = None,
                noise: Optional[Draws] = None, fed=None):
        """x (B, L, Dc) manager features, critic_mask (B, L) segment labels
        -> (B, L, d_goal) goals. ``drop``: dropout draws (None: none);
        ``noise``: the exploration normal's draws (needed if
        ``exploration``); ``fed``: the cross-rank flags of the expansion
        (``ops.segments.expand_goals``)."""
        x = dropout(self.linear(x.float()), self.dout_p, drop)
        if exploration:
            xd = x.detach()
            centre = mesh_lib.global_nanmean(xd, self.mesh)
            mean = centre / self.MEAN_FACTOR
            std = torch.sqrt(mesh_lib.global_nanmean(
                (xd - centre).abs() ** 2, self.mesh)) / self.STD_FACTOR
            x = x + (noise.normal((self.d_goal,)) * std + mean - 0.5 * mean)
        return expand_goals(x, critic_mask, self.mesh, fed)


class Worker(nn.Module):
    """Goal-conditioned word head: 2-head goal attention over the worker
    features, concat, f32 projection to vocabulary log-probs."""

    def __init__(self, voc_size, d_in, d_goal, d_model, dtype, device,
                 dout_p: float = 0.0):
        super().__init__()
        self.dtype = dtype
        self.goal_attention = MultiheadedAttention(
            d_goal, d_in, d_in, 2, d_model, dtype=dtype, device=device,
            dout_p=dout_p)
        self.projection = Dense(d_in + d_goal, voc_size, torch.float32, device)

    def forward(self, x, goal, mask, draws=None):
        """x (B, L, Dc) worker features, goal (B, L, d_goal), mask the
        caption mask -> (B, L, V) log-probs."""
        gc = self.goal_attention(goal.to(self.dtype), x, x, mask, draws)
        h = torch.cat([x, gc.to(x.dtype)], dim=-1)
        return torch.log_softmax(self.projection(h.float()), dim=-1)

    def step_raw(self, wf_t, goal_t, wf_cache, t, key_mask,
                 fw: FoldedWeights):
        """Single-position head over the RAW worker-feature cache (B, L, Dc),
        with the goal attention's K/V/out projections folded (``fw``). The
        cache holds the compute-dtype features in f32 and is written IN
        PLACE at position t (a 0-d int64 tensor)."""
        att = self.goal_attention
        dt = self.dtype
        wf_cache.index_copy_(1, t.reshape(1), wf_t.float())
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

    def frontier(self, wf_t, worker_feat, goal_t, mask_row):
        """Head at one position of a full buffer: goal_t (B, 1, d_goal)
        attends the whole worker-feature buffer (B, L, Dc) under the
        caption mask's row ``mask_row`` (B, 1, L); the vocabulary
        projection runs on the frontier's features wf_t (B, 1, Dc) only.
        Returns (B, V) log-probs."""
        gc = self.goal_attention(goal_t.to(self.dtype), worker_feat,
                                 worker_feat, mask_row)
        h = torch.cat([wf_t, gc.to(wf_t.dtype)], dim=-1)
        return torch.log_softmax(self.projection(h.float())[:, 0], dim=-1)


class HierarchicalAgent(nn.Module):
    """What the two families of hierarchical captioner share (the bimodal
    ``BMHrlAgent`` and the unimodal ``models.unimodal.UnimodalAgent``): the
    frozen critic's segment labels, the Manager's goals and the Worker's
    vocabulary head over the two fusion stacks' features, teacher-forced
    (``forward``) or stepped one token at a time (the decode). A subclass
    builds ``emb_C``, ``pos_enc_C``, ``critic``, ``manager`` and
    ``worker`` and gives its encoder and fusion stacks:

    - ``encode(V, A, masks, draws)`` -> (Va, Av) memories;
    - ``fusion_features(C, Va, Av, masks, drop, kv)`` -> (worker features,
      manager features) of a whole caption;
    - ``precompute_fusion_kv(Va, Av)``: the stacks' cross-attention
      keys/values, once per decode;
    - ``fusion_layer(s, i)``: layer i of stack s (0 worker, 1 manager), with
      ``step_weights``, ``step_mem_pre`` and ``step_mem_post``;
    - ``decode_memories(Va, Av, masks)``: the memories the token step
      attends, in the order of ``step_mem_pre``'s effective queries, each
      with its (B, S) int32 key mask.

    ``mesh``: the data-parallel mesh (``parallel.mesh``) the decode loops
    stop over and the Manager expands goals over (None: one process)."""

    mesh = None

    @property
    def device(self) -> torch.device:
        return self.emb_C.embedding.weight.device

    def segment_labels_of(self, C_emb: torch.Tensor) -> torch.Tensor:
        """(B, L, Dc) caption embeddings -> (B, L) int32 segment labels of
        the frozen critic."""
        scores = torch.sigmoid(self.critic(C_emb))
        return (scores > self.critic_score_threshold).to(torch.int32)[..., 0]

    def predict_with_features(self, C_emb, Va, Av, masks,
                              exploration: bool = False,
                              deterministic: bool = True,
                              draws: Optional[Draws] = None):
        """Caption side of ``forward`` against encoder memories Va, Av.
        Returns (log_probs, worker_feat, manager_feat, goals, labels)."""
        drop = None if deterministic else draws
        labels = self.segment_labels_of(C_emb)
        C = self.pos_enc_C(C_emb, drop).to(self.dtype)
        worker_feat, manager_feat = self.fusion_features(C, Va, Av, masks,
                                                         drop)
        goals = self.manager(manager_feat, labels, exploration, drop, draws)
        pred = self.worker(worker_feat, goals, masks["C_mask"], drop)
        return pred, worker_feat, manager_feat, goals, labels

    def forward(self, V, A, trg, masks, mix_factor=None,
                exploration: bool = False, deterministic: bool = True,
                draws: Optional[Draws] = None):
        """Teacher-forced forward: features V (B, Sv, d_video), A (B, Sa,
        d_audio), caption tokens trg (B, L), masks from
        ``ops.masking.make_masks(..., trg)``. ``trg`` may be a pair (y,
        y_hat) of ground-truth and model tokens: the scheduled-sampling
        input, embeddings mixed as emb(y)(1 - f) + emb(y_hat) f with f =
        ``mix_factor`` (1 when None). With ``deterministic=False`` dropout
        is on and with ``exploration`` the Manager adds noise; both draw
        from ``draws``. Returns (log_probs (B, L, V), worker_feat,
        manager_feat, goals, segment labels (B, L))."""
        if (exploration or not deterministic) and draws is None:
            raise ValueError("a forward with dropout or exploration needs "
                             "draws")
        if isinstance(trg, (tuple, list)):
            y, y_hat = trg
            f = 1.0 if mix_factor is None else mix_factor
            C_emb = self.emb_C(y) * (1.0 - f) + self.emb_C(y_hat) * f
        else:
            C_emb = self.emb_C(trg)
        Va, Av = self.encode(V, A, masks, None if deterministic else draws)
        return self.predict_with_features(C_emb, Va, Av, masks, exploration,
                                          deterministic, draws)

    # ---- the full-buffer decode: the fusion stacks over the whole buffer
    # every token, heads at the frontier only
    def critic_init_state(self, B: int) -> Dict:
        return self.critic.init_state(B)

    def critic_step_weights(self) -> Dict:
        """The frozen critic's cells packed once per decode."""
        return self.critic.step_weights()

    def critic_step(self, tok_t, state, crit_w):
        """Advance the frozen critic by token ids (B,) -> ((B,) logit,
        state); ``crit_w``: the critic's ``step_weights()``."""
        score, state = self.critic.step(self.emb_C(tok_t[:, None])[:, 0],
                                        state, crit_w)
        return score[:, 0], state

    def frontier_head(self, trg, labels):
        """The full-buffer token's input to its cross-row rule: (head for
        ``decode_frontier``, the rows' boundary flags the ranks exchange)."""
        return (), labels.bool().any(dim=1)

    def decode_frontier(self, trg, labels, Va, Av, masks, t: torch.Tensor,
                        exploration: bool = False,
                        fusion_kv: Optional[Dict] = None,
                        draws: Optional[Draws] = None, head=None, fed=None):
        """Log-probs (B, V) at position t of the buffer trg (B, L) with the
        critic's segment labels (B, L) (zero past t), under ``masks`` with
        the caption mask "C_mask": the fusion stacks run over the whole
        buffer, the Manager's linear, the goal query and the vocabulary
        projection at position t (a 0-d int64 tensor) only. With
        ``exploration`` the goal gets
        the Manager's noise with statistics over positions <= t
        (``ops.segments.frontier_exploration_noise``, one normal draw from
        ``draws``). ``head``: ``frontier_head``'s (nothing here); ``fed``:
        the cross-rank flags of the goals (``ops.segments.frontier_goal``;
        None: exchanged over the mesh here)."""
        C = self.pos_enc_C(self.emb_C(trg)).to(self.dtype)
        worker_feat, manager_feat = self.fusion_features(C, Va, Av, masks,
                                                         None, fusion_kv)
        at = t.reshape(1)
        x_t = self.manager.linear(manager_feat.index_select(1, at).float())
        if exploration:
            x_t = x_t + frontier_exploration_noise(
                self.manager.linear(manager_feat.float()), t,
                self.manager.d_goal, draws, Manager.MEAN_FACTOR,
                Manager.STD_FACTOR, self.mesh)
        goal_t = frontier_goal(x_t, labels.index_select(1, at)[:, 0],
                               labels.bool().any(dim=1), self.mesh, fed)
        return self.worker.frontier(worker_feat.index_select(1, at),
                                    worker_feat, goal_t,
                                    masks["C_mask"].index_select(1, at))

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

    def decode_step_head(self, tok_t, t: torch.Tensor, crit_state, crit_w):
        """Embed token t, advance the frozen critic one step, position-encode
        (row t, a 0-d int64 tensor, of the table). ``crit_w``: the critic's
        ``step_weights()``, packed once per decode. Returns (c_t (B, 1, Dc)
        compute dtype, label_t (B,) int, state)."""
        emb_t = self.emb_C(tok_t[:, None])
        score_t, crit = self.critic.step(emb_t[:, 0], crit_state, crit_w)
        label_t = (torch.sigmoid(score_t[:, 0])
                   > self.critic_score_threshold).to(torch.int32)
        pe = self.pos_enc_C.table.index_select(0, t.reshape(1))
        c_t = (emb_t + pe).to(self.dtype)
        return c_t, label_t, crit

    def decode_step_tail(self, wf_t, mf_t, label_t, hb, goal_cache,
                         t: torch.Tensor, key_mask, goal_fw: FoldedWeights,
                         fed=None):
        """Goal emission + worker head at the boundary flags ``hb`` (label
        t included). Returns (B, V) log-probs."""
        goal_t = self.manager.goal_step(mf_t, label_t, hb, fed)
        return self.worker.step_raw(wf_t, goal_t, goal_cache, t, key_mask,
                                    goal_fw)

    # the fast loop has every position's inputs once it reaches it
    has_fast_loop = True

    def fast_state(self, Va, Av, masks_src, B: int, L: int):
        """The fast loop's start: (caches0, valid0, inv). ``caches0`` the
        per-row state of ``init_decode_caches`` for B rows; ``valid0`` (B,
        L) bool, PAD-validity of consumed positions (<s> at 0 valid by
        definition); ``inv`` the loop-invariant inputs of ``fast_step``:
        the fusion layers' weights (merged QKV, folded projections), the
        critic's cells packed once, the goal attention's folded weights and
        the memories with their key masks (at clip level)."""
        caches0 = self.init_decode_caches(B, L)
        N = self.att_layers
        inv = {"sw": [[self.fusion_layer(s, i).step_weights()
                       for i in range(N)] for s in range(2)],
               "crit_w": self.critic.step_weights(),
               "goal_fw": self.worker.goal_attention.folded_weights(),
               # the bimodal agent's audio and video memories; the
               # unimodal one's
               "mems": self.decode_memories(Va, Av, masks_src)}
        valid0 = torch.zeros(B, L, dtype=torch.bool, device=Va.device)
        valid0[:, 0] = True
        return caches0, valid0, inv

    # a token's step has a cross-row rule (the goals' ``frontier_goal``):
    # it is cut into a head and a body around the exchange of the boundary
    # flags (``fast_step_head``/``fast_step_body``; the full-buffer loop's
    # ``train.decode.full_step_head``/``full_step_body``), and
    # ``serve_export`` exports each half
    cross_row_step = True

    def fast_step_head(self, tok_t, t: torch.Tensor, caches, inv):
        """The token's step up to its cross-row rule: embed, the frozen
        critic's step, the segment label and the boundary flag. Returns
        (head, caches, flag): ``head`` = (c_t, label_t) for the body,
        ``caches`` with the critic state and the boundary flags new, and
        ``flag`` (B,) the boundary flags the ranks exchange."""
        c_t, label_t, crit = self.decode_step_head(tok_t, t,
                                                   caches["critic"],
                                                   inv["crit_w"])
        hb = caches["hb"] | label_t.bool()
        return (c_t, label_t), dict(caches, critic=crit, hb=hb), hb

    def fast_step_body(self, head, t: torch.Tensor, caches, valid, inv,
                       beam_share: int = 1, fed=None):
        """The token's step after its head: the two fusion stacks, then the
        goals and the worker head (``decode_step_tail``) under the
        cross-rank flags ``fed`` (``parallel.mesh.cross_flags``; None:
        these rows are the batch). Writes the KV and goal caches in place;
        returns the log-probs (B, V).

        ``beam_share`` = W > 1: B counts ROWS (clips x beams, clip-major)
        while the memories stay at clip level; the W beams of a clip fold
        into the query-group axis of ``folded_attend`` (one call per memory
        and layer, G = 2 x heads x W)."""
        N, H = self.att_layers, self.att_heads
        scale = 1.0 / math.sqrt(self.d_model // H)
        sw = inv["sw"]

        def attend(q_rows, mem, mask):
            # (rows, 2H, draw) -> (clips, W x 2H, draw): each clip's memory
            # is read once for all its beams (rows are clip-major)
            R, G, draw = q_rows.shape
            ctx = fused.folded_attend(
                q_rows.reshape(R // beam_share, beam_share * G, draw), mem,
                mask, scale)
            return ctx.reshape(R, G, draw)

        c_t, label_t = head
        c = [c_t, c_t]
        for i in range(N):
            layers = [self.fusion_layer(s, i) for s in range(2)]
            pre = [layers[s].step_mem_pre(c[s], t, caches["fus"][s][i], valid,
                                          sw[s][i]) for s in range(2)]
            # per memory, worker heads first, then manager heads:
            # (rows, 2H, draw)
            ctx = [attend(torch.cat([pre[0][1 + j], pre[1][1 + j]], dim=1),
                          mem, mask)
                   for j, (mem, mask) in enumerate(inv["mems"])]
            c = [layers[s].step_mem_post(
                pre[s][0], *(x[:, s * H:(s + 1) * H] for x in ctx),
                sw[s][i]) for s in range(2)]
        return self.decode_step_tail(c[0], c[1], label_t, caches["hb"],
                                     caches["goal"], t, valid,
                                     inv["goal_fw"], fed)

    def fast_step(self, tok_t, t: torch.Tensor, caches, valid, inv,
                  beam_share: int = 1):
        """One token of the fast loop: token ids tok_t (B,), position t (a
        0-d int64 tensor), the caches (written IN PLACE: KV and goal
        caches; the critic state and the boundary flag come back new),
        ``valid`` and ``fast_state``'s ``inv``. Returns (log-probs (B, V),
        caches). ``fast_step_head``, the boundary flags exchanged over the
        model's mesh (one all_reduce with ranks; nothing alone), then
        ``fast_step_body``."""
        head, caches, flag = self.fast_step_head(tok_t, t, caches, inv)
        fed = mesh_lib.cross_flags(flag, self.mesh)
        return self.fast_step_body(head, t, caches, valid, inv, beam_share,
                                   fed), caches

    def fast_setup(self, Va, Av, masks_src, B: int, L: int,
                   beam_share: int = 1):
        """The fast loop's state and per-token step (``train.decode``):
        (caches0, valid0, step_fn) with ``step_fn(tok_t, t, caches, valid)
        -> (log-probs, caches)`` (t a 0-d int64 tensor); the step writes the
        caches it is given in place, so after a parent gather the next step
        writes into the gathered tensors. ``fast_state`` and ``fast_step``
        are its two halves (``serve_export`` exports each)."""
        caches0, valid0, inv = self.fast_state(Va, Av, masks_src, B, L)

        def step_fn(tok_t, t, caches, valid):
            return self.fast_step(tok_t, t, caches, valid, inv, beam_share)

        return caches0, valid0, step_fn


class BMHrlAgent(HierarchicalAgent):
    """Bimodal hierarchical captioner. Defaults are the flagship's:
    vocabulary given, d_model 1024, 4 heads, 2 layers, d_caps 300, dropout
    0.1, bf16 compute. Parameters are f32 on ``device`` ("cuda" by default;
    "cpu" runs the kernels' plain versions; "meta" builds shapes only)."""

    def __init__(self, voc_size: int, d_video: int = 1024, d_audio: int = 128,
                 d_model: int = 1024, d_model_caps: int = 300,
                 att_heads: int = 4, att_layers: int = 2, dout_p: float = 0.1,
                 d_goal: int = 64, d_ff_v: int = 1024, d_ff_a: int = 512,
                 d_ff_c: int = 2048, critic_score_threshold: float = 0.25,
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
        self.pos_enc_A = PositionalEncoder(d_audio, dout_p, device)
        self.pos_enc_V = PositionalEncoder(d_video, dout_p, device)
        self.pos_enc_C = PositionalEncoder(d_model_caps, dout_p, device)
        self.critic = SegmentCritic(d_model_caps, device)
        self.emb_C = VocabularyEmbedder(voc_size, d_model_caps, device)
        self.bm_enc = BMEncoder(
            att_layers, d_model_M1=d_video, d_model_M2=d_audio,
            d_model=d_model, d_ff_M1=d_ff_v, d_ff_M2=d_ff_a, H=att_heads,
            dtype=dtype, use_flash=use_flash, device=device, dout_p=dout_p)
        fus = dict(d_model_A=d_audio, d_model_V=d_video,
                   d_model_C=d_model_caps, d_model=d_model, H=att_heads,
                   dtype=dtype, device=device, use_flash=use_flash,
                   dout_p=dout_p)
        self.bm_worker_fus = BMFusion(att_layers, **fus)
        self.bm_manager_fus = BMFusion(att_layers, **fus)
        self.manager = Manager(d_model_caps, d_goal, device, dout_p)
        self.worker = Worker(voc_size, d_model_caps, d_goal, d_model, dtype,
                             device, dout_p)

    def encode(self, V, A, masks, draws: Optional[Draws] = None):
        """(B, Sv, d_video), (B, Sa, d_audio) features -> (Va, Av) memories
        in the compute dtype. ``draws``: dropout draws (None: none)."""
        V = self.pos_enc_V(V.to(self.dtype), draws)
        A = self.pos_enc_A(A.to(self.dtype), draws)
        return self.bm_enc(V, A, masks["V_mask"], masks["A_mask"], draws)

    def fusion_features(self, C, Va, Av, masks, drop=None,
                        fusion_kv: Optional[Dict] = None):
        """(worker, manager) features of the caption C (B, L, Dc) over the
        memories; ``fusion_kv``: ``precompute_fusion_kv`` (None: project
        here)."""
        kv = fusion_kv or {}
        return (self.bm_worker_fus(C, Av, Va, masks, drop, kv.get("worker")),
                self.bm_manager_fus(C, Av, Va, masks, drop,
                                    kv.get("manager")))

    def precompute_fusion_kv(self, Va, Av) -> Dict:
        """Both stacks' cross-attention keys/values of the memories, once
        per decode."""
        return {"worker": self.bm_worker_fus.precompute_kv(Av, Va),
                "manager": self.bm_manager_fus.precompute_kv(Av, Va)}

    def fusion_layer(self, s: int, i: int) -> BMFusionLayer:
        return (self.bm_worker_fus, self.bm_manager_fus)[s].layer(i)

    def decode_memories(self, Va, Av, masks) -> List:
        """The audio memory, then the video memory, each with its key mask
        (the order of ``BMFusionLayer.step_mem_pre``'s queries)."""
        return [(Av, masks["A_mask"][:, 0, :].to(torch.int32).contiguous()),
                (Va, masks["V_mask"][:, 0, :].to(torch.int32).contiguous())]


class _ValueFunction(nn.Module):
    """Reward baseline: FFN(d, 2d) -> ReLU -> Linear(d -> 1), f32, under the
    JAX module's parameter names (``value_function``, ``projection``). The
    steps run it without dropout, as the JAX steps do, so it has none."""

    def __init__(self, d_model_caps: int = 300, device="cuda"):
        super().__init__()
        if torch.device(device).type != "meta":
            device = resolve_device(device)
        d = d_model_caps
        self.value_function = PositionwiseFeedForward(d, 2 * d, torch.float32,
                                                      device)
        self.projection = Dense(d, 1, torch.float32, device)

    def forward(self, x):
        return self.projection(torch.relu(self.value_function(x.float())))


class BMWorkerValueFunction(_ValueFunction):
    """Worker reward baseline on worker features (the JAX module also takes
    the goals and ignores them)."""


class BMManagerValueFunction(_ValueFunction):
    """Manager reward baseline on manager features."""
