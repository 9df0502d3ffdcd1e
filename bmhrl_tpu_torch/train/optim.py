"""GatedAdam: torch-semantics Adam with per-parameter step counts and an
activity mask applied at update time (the port of
bmhrl_tpu/train/optim.py).

The reference gates its training phases by flipping ``requires_grad`` on
module groups under one ``torch.optim.Adam``: a parameter outside the phase
gets no gradient, so its moments and its own step count freeze and resume
when the phase comes back. ``update(grads, state, params, active, lr)``
does that with a mask: inactive parameters keep their values, moments and
counts. torch weight-decay semantics (L2 added to the gradient). The
update of a step runs as a few ``torch._foreach_*`` calls over the active
parameters, with the arithmetic of the JAX leaf update.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Union

import torch


class AdamState(NamedTuple):
    count: Dict[str, int]   # per parameter, on the host
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]


class GatedAdam:
    def __init__(self, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-4,
                 weight_decay: float = 0.0):
        self.b1, self.b2, self.eps, self.wd = b1, b2, eps, weight_decay

    def init(self, params: Dict[str, torch.Tensor]) -> AdamState:
        return AdamState(
            count={n: 0 for n in params},
            mu={n: torch.zeros_like(p, dtype=torch.float32)
                for n, p in params.items()},
            nu={n: torch.zeros_like(p, dtype=torch.float32)
                for n, p in params.items()})

    @torch.no_grad()
    def update(self, grads: Dict[str, Optional[torch.Tensor]],
               state: AdamState, params: Dict[str, torch.Tensor],
               active: Union[bool, Dict[str, bool]], lr: float) -> AdamState:
        """Update the active parameters IN PLACE; returns the new state. A
        missing gradient (None: the loss does not reach the parameter)
        counts as zero, as JAX's gradient of it is."""
        names = [n for n in params if active is True or active[n]]
        if not names:
            return state
        b1, b2 = self.b1, self.b2
        ps = [params[n] for n in names]
        gs = [torch.zeros_like(params[n]) if grads.get(n) is None
              else grads[n].float() for n in names]
        if self.wd:
            gs = torch._foreach_add(gs, ps, alpha=self.wd)
        ms = [state.mu[n] for n in names]
        vs = [state.nu[n] for n in names]
        count = dict(state.count)
        for n in names:
            count[n] += 1
        torch._foreach_mul_(ms, b1)
        torch._foreach_add_(ms, gs, alpha=1 - b1)
        torch._foreach_mul_(vs, b2)
        torch._foreach_addcmul_(vs, gs, gs, value=1 - b2)
        mhat = torch._foreach_div(ms, [1 - b1 ** count[n] for n in names])
        den = torch._foreach_div(vs, [1 - b2 ** count[n] for n in names])
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        torch._foreach_mul_(mhat, lr)
        torch._foreach_div_(mhat, den)
        torch._foreach_sub_(ps, mhat)
        return AdamState(count=count, mu=state.mu, nu=state.nu)


def clip_by_global_norm(grads: Dict[str, Optional[torch.Tensor]],
                        max_norm: float) -> Dict[str, Optional[torch.Tensor]]:
    """torch ``clip_grad_norm_`` semantics plus a non-finite guard: when the
    global norm is inf or nan every gradient becomes zero (the batch loses
    its step instead of poisoning the parameters). No host sync."""
    present = [g for g in grads.values() if g is not None]
    if not present:
        return grads
    norm = torch.sqrt(sum(g.float().square().sum() for g in present))
    scale = torch.clamp(max_norm / (norm + 1e-6), max=1.0)
    ok = torch.isfinite(norm)
    return {n: None if g is None
            else torch.where(ok, (g * scale).to(g.dtype), torch.zeros_like(g))
            for n, g in grads.items()}
