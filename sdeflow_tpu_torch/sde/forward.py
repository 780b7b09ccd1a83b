"""Forward (noising) flow adapter.

Port of sdeflow_tpu/sde/forward.py: wraps a base SDE into the flow protocol
of ops/integrators.py for the noising direction:
  Itô drift        mu        = f_strato + ½ div Σ
  Stratonovich     mu_strato = f_strato
  diffusion action sigma     = g
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

from sdeflow_tpu_torch.ops.integrators import rk4_step as generic_rk4


@dataclass(frozen=True)
class ForwardFlow:
    base_sde: Any
    T: float

    def mu(self, t, y, lmbd=0.0):
        return self.base_sde.f_strato(t, y) + 0.5 * self.base_sde.div_sigma(t, y)

    def mu_strato(self, t, y, lmbd=0.0):
        return self.base_sde.f_strato(t, y)

    def sigma_apply(self, t, y, w, lmbd=0.0):
        return self.base_sde.sigma_apply(t, y, w)

    def rk4_step(self, t, x, delta, dW, lmbd=0.0):
        """One RK4 step: the base SDE's fused whole step when it has one
        (circulant MSGM: kernel K2), else (a dense G too) the generic
        stages."""
        fused = getattr(self.base_sde, "fused_forward_rk4_step", None)
        if fused is not None:
            out = fused(t, x, delta, dW)
            if out is not None:
                return out
        return generic_rk4(self, t, x, delta, dW, lmbd)

    @property
    def rk4_solve_select(self):
        """The whole-solve override of integrate_select: the base SDE's
        fused forward RK4 solve with the per-sample select (circulant MSGM:
        one launch of K2's solve), called as (x0, z, delta, select_idx);
        None where the base SDE has none, and its result None where the
        base SDE takes no fused solve (a dense G)."""
        return getattr(self.base_sde, "fused_forward_rk4_solve_select", None)
