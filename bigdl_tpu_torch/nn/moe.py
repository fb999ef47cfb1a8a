"""Mixture of experts (``bigdl_tpu/nn/moe.py``: ``MixtureOfExperts`` :23,
``capacity`` :108, ``route`` :122, ``route_compact`` :194,
``grouped_dispatch``/``grouped_combine`` :236-262, ``set_expert_parallel``
:264, ``apply`` :295, ``_apply_expert_parallel`` :320).

Top-k token routing with a capacity bound: the Switch configuration at
``top_k=1``, GShard's at ``top_k=2``.  The experts are copies of one
template module whose parameters are stacked along a leading expert dim
and run as one batched product over the experts (``torch.func.vmap`` of
the template's forward).  Two executions of the same routing decisions
(``bigdl.moe.impl``): ``einsum`` (the default) builds the one-hot
(tokens, E, C) dispatch and combine tensors; ``grouped`` scatters the kept
assignments into the (E, C, d) expert batch and gathers them back.  Expert
parallelism over a mesh's ``expert`` axis is
:mod:`bigdl_tpu_torch.parallel.expert_parallel`.
"""

from __future__ import annotations

import copy
import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call, vmap

from bigdl_tpu_torch.engine import bound_axis
from bigdl_tpu_torch.nn.init import RandomUniform, Xavier
from bigdl_tpu_torch.nn.linear import Linear
from bigdl_tpu_torch.nn.module import (Module, make_generator,
                                       semantic_state_leaves)


class _Live(dict):
    """The last forward's live diagnostics: still in the autograd graph,
    so a copy or a pickle of the module starts without them."""

    def __deepcopy__(self, memo):
        return _Live()

    def __reduce__(self):
        return (_Live, ())


class MixtureOfExperts(Module):
    """Top-k gated mixture of ``n_experts`` copies of ``expert``, a
    stateless module mapping (tokens, d_model) to (tokens, d_model).

    Routing: a softmax gate over the experts (``gate``, (d_model, E), as
    in the JAX package); each token goes to its ``top_k`` largest gates,
    the lower expert index first on a tie (``lax.top_k``'s rule, made
    explicit with a stable sort).  ``top_k=1`` scales the expert's output
    by the raw gate, ``top_k>1`` by the selected gates renormalised to sum
    to 1.  Each expert takes at most :meth:`capacity` tokens per forward
    over all tiers; tier k queues after every earlier tier of the same
    expert, and what overflows contributes zero.  Queue positions are
    int32, so a bf16 forward cannot round them.

    Capacity is per forward: a batch split into independent forwards
    (the expert-parallel token shards) routes each part with its own
    budget, and equals the whole-batch forward only where nothing drops
    (``capacity_factor >= n_experts / top_k``) or ``capacity=`` pins the
    budget.  The Switch balance diagnostic ``E * sum_e(token_fraction_e *
    mean_gate_e)`` (1 for a uniform router) is the buffer ``aux_loss``
    after a training forward, and the live value of every forward is
    what :func:`~bigdl_tpu_torch.nn.module.collect_diagnostics` returns.

    Parameters: ``gate`` and the template's parameters, each with a
    leading dim of ``n_experts`` (``expert.<name>``).  Every ``Linear`` of
    each expert is drawn afresh with its own default initialiser; other
    parameters start as the template's.  A template with state (a
    BatchNorm) raises :class:`ValueError`."""

    diagnostic_state_keys = ("aux_loss",)

    def __init__(self, d_model: int, expert: nn.Module, n_experts: int,
                 capacity_factor: float = 1.25, top_k: int = 1,
                 capacity: Optional[int] = None,
                 device: Optional[torch.device] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if not 1 <= top_k <= n_experts:
            raise ValueError(f"top_k {top_k} must be in [1, {n_experts}]")
        if capacity is not None and capacity < 1:
            raise ValueError(f"capacity {capacity} must be >= 1")
        if semantic_state_leaves(expert):
            raise ValueError(
                "MixtureOfExperts experts must be stateless (no BatchNorm "
                "running statistics) — state updates cannot be threaded "
                "through the routed dispatch")
        self.d_model = d_model
        self.n_experts = n_experts
        self.capacity_factor = capacity_factor
        self.top_k = top_k
        self.fixed_capacity = capacity
        self.expert_parallel: Optional[str] = None
        self._ep_shards = 1
        self._diagnostics: Dict[str, torch.Tensor] = _Live()
        g = make_generator(generator)
        gate = Xavier()((d_model, n_experts), d_model, n_experts,
                        generator=g)
        self.gate = nn.Parameter(gate.to(device))
        copies = []
        for _ in range(n_experts):
            c = copy.deepcopy(expert).cpu()
            with torch.no_grad():
                for m in c.modules():
                    if isinstance(m, Linear):
                        m.set_init_method(RandomUniform(), RandomUniform(),
                                          generator=g)
            copies.append(dict(c.named_parameters()))
        self.expert = copy.deepcopy(expert)
        for name, _ in list(self.expert.named_parameters()):
            owner, leaf = self._owner(name)
            owner._parameters[leaf] = nn.Parameter(
                torch.stack([c[name].detach() for c in copies]).to(device))
        self.register_buffer("aux_loss", torch.zeros((), device=device))

    def _owner(self, name: str):
        *path, leaf = name.split(".")
        m = self.expert
        for p in path:
            m = getattr(m, p)
        return m, leaf

    def stacked_parameters(self) -> Dict[str, torch.Tensor]:
        """The experts' stacked parameters by the template's names, each
        (n_experts, ...)."""
        return {n: getattr(*self._owner(n))
                for n, _ in self.expert.named_parameters()}

    # ---- routing -----------------------------------------------------------

    def capacity(self, n_tokens: int) -> int:
        """Per-expert token capacity of a forward over ``n_tokens``:
        GShard's ``ceil(t * k / E * capacity_factor)``, or ``capacity=``
        where given.  Under expert parallelism it applies per rank."""
        if self.fixed_capacity is not None:
            return self.fixed_capacity
        return max(1, math.ceil(n_tokens * self.top_k / self.n_experts
                                * self.capacity_factor))

    def _gates_top_k(self, flat: torch.Tensor):
        gates = torch.softmax(flat @ self.gate, dim=-1)         # (t, E)
        vals, idx = torch.sort(gates, dim=-1, descending=True, stable=True)
        return gates, vals[:, :self.top_k], idx[:, :self.top_k]

    def _queues(self, top_idx: torch.Tensor):
        """Per tier: the one-hot (t, E) int32 assignment and the queue
        position of every (token, expert) cell, tier k after the earlier
        tiers of the same expert."""
        counts = torch.zeros(self.n_experts, dtype=torch.int32,
                             device=top_idx.device)
        out = []
        for k in range(self.top_k):
            oh = F.one_hot(top_idx[:, k], self.n_experts).to(torch.int32)
            pos = (torch.cumsum(oh, dim=0, dtype=torch.int32) * oh - 1) \
                + counts[None, :] * oh
            out.append((oh, pos))
            counts = counts + oh.sum(dim=0, dtype=torch.int32)
        return out

    def _aux(self, gates: torch.Tensor, top1_oh: torch.Tensor):
        frac_tokens = top1_oh.to(gates.dtype).mean(dim=0)
        return self.n_experts * torch.sum(frac_tokens * gates.mean(dim=0))

    def _denom(self, top_gates: torch.Tensor) -> torch.Tensor:
        if self.top_k > 1:
            return top_gates.sum(dim=1, keepdim=True).clamp_min(1e-9)
        return torch.ones_like(top_gates)

    def route(self, flat: torch.Tensor):
        """(tokens, d) -> (dispatch (t, E, C), combine (t, E, C), aux):
        the 0/1 slot each kept assignment occupies, the same weighted by
        its (renormalised) gate, and the Switch balance scalar."""
        t = flat.shape[0]
        cap = self.capacity(t)
        gates, top_gates, top_idx = self._gates_top_k(flat)
        denom = self._denom(top_gates)
        dispatch = combine = 0
        queues = self._queues(top_idx)
        slots = torch.arange(cap, dtype=torch.int32, device=flat.device)
        for k, (oh, pos) in enumerate(queues):
            # a kept cell is one of its token's chosen experts, so this is
            # the JAX package's one_hot(slot) * one_hot(expert)
            keep = (pos >= 0) & (pos < cap) & (oh > 0)
            slot = ((pos[:, :, None] == slots) & keep[:, :, None]).to(
                flat.dtype)
            dispatch = dispatch + slot
            combine = combine + slot * (top_gates[:, k:k + 1]
                                        / denom[:, :1])[:, :, None]
        return dispatch, combine, self._aux(gates, queues[0][0])

    def route_compact(self, flat: torch.Tensor):
        """(tokens, d) -> (expert_id (t, k), slot (t, k), weight (t, k),
        keep (t, k), aux): :meth:`route`'s decisions token-major.
        ``weight`` carries the keep mask, so a dropped assignment adds
        exactly zero."""
        t = flat.shape[0]
        cap = self.capacity(t)
        gates, top_gates, top_idx = self._gates_top_k(flat)
        queues = self._queues(top_idx)
        slot = torch.stack([pos.gather(1, top_idx[:, k:k + 1])[:, 0]
                            for k, (_, pos) in enumerate(queues)], dim=1)
        keep = slot < cap
        wgt = (top_gates / self._denom(top_gates)) * keep.to(flat.dtype)
        return top_idx, slot, wgt, keep, self._aux(gates, queues[0][0])

    def grouped_dispatch(self, flat: torch.Tensor, expert_id, slot, keep,
                         cap: int) -> torch.Tensor:
        """Scatter the kept assignments into the (E, C, d) expert batch
        (row ``expert_id * C + slot``; dropped ones into a discarded
        overflow row): what the dispatch einsum builds."""
        t, d = flat.shape
        dump = self.n_experts * cap
        rows = torch.where(keep, expert_id * cap + slot,
                           torch.full_like(slot, dump))
        tok = torch.arange(t, device=flat.device).repeat_interleave(
            self.top_k)
        buf = flat.new_zeros(dump + 1, d).index_add(
            0, rows.reshape(-1).long(), flat[tok])
        return buf[:dump].reshape(self.n_experts, cap, d)

    def grouped_combine(self, expert_out: torch.Tensor, expert_id, slot,
                        wgt, keep, cap: int) -> torch.Tensor:
        """Gather each assignment's expert output and sum the tiers
        weighted by ``wgt``: the combine einsum without its (t, E, C)
        tensor."""
        d = expert_out.shape[-1]
        rows = torch.where(keep, expert_id * cap + slot,
                           torch.zeros_like(slot))
        picked = expert_out.reshape(self.n_experts * cap, d)[
            rows.reshape(-1).long()].reshape(rows.shape + (d,))
        return torch.sum(picked * wgt[:, :, None], dim=1)

    @staticmethod
    def _impl() -> str:
        from bigdl_tpu_torch.utils import config
        impl = str(config.get_property("bigdl.moe.impl", "einsum")
                   or "einsum").lower()
        if impl not in ("einsum", "grouped"):
            raise ValueError(f"bigdl.moe.impl={impl!r}: expected 'einsum' "
                             "or 'grouped'")
        return impl

    # ---- the experts -------------------------------------------------------

    def set_expert_parallel(self, axis_name: Optional[str],
                            n_shards: int) -> "MixtureOfExperts":
        """Wire the mesh axis ``axis_name`` (None: off): while it is bound
        (:func:`bigdl_tpu_torch.engine.bind_axes`, inside the trainer's
        step) the forward dispatches with ``all_to_all`` and runs only
        this rank's ``n_experts / n_shards`` experts; outside it the
        whole layer runs here."""
        if axis_name is not None and self.n_experts % n_shards != 0:
            raise ValueError(
                f"n_experts {self.n_experts} must divide by the expert "
                f"axis size {n_shards}")
        self.expert_parallel = axis_name
        self._ep_shards = n_shards if axis_name is not None else 1
        return self

    def expert_forward(self, expert_in: torch.Tensor,
                       experts: Optional[Dict[str, torch.Tensor]] = None
                       ) -> torch.Tensor:
        """The template's forward over the stacked (E, C, d) batch, one
        batched product per layer; ``experts`` replaces the stacked
        parameters (the expert-parallel path passes its slice)."""
        stacked = self.stacked_parameters() if experts is None else experts

        def one(p, x):
            return functional_call(self.expert, p, (x,))
        return vmap(one)(stacked, expert_in)

    def forward(self, input: torch.Tensor) -> torch.Tensor:
        flat = input.reshape(-1, self.d_model)
        ep = bound_axis(self.expert_parallel)
        if ep is not None:
            from bigdl_tpu_torch.parallel.expert_parallel import \
                apply_expert_parallel
            out, aux = apply_expert_parallel(self, flat, ep[0], ep[1],
                                             ep[2])
        elif self._impl() == "grouped":
            eid, slot, wgt, keep, aux = self.route_compact(flat)
            cap = self.capacity(flat.shape[0])
            expert_out = self.expert_forward(
                self.grouped_dispatch(flat, eid, slot, keep, cap))
            out = self.grouped_combine(expert_out, eid, slot, wgt, keep,
                                       cap)
        else:
            dispatch, combine, aux = self.route(flat)
            expert_out = self.expert_forward(
                torch.einsum("tec,td->ecd", dispatch, flat))
            out = torch.einsum("tec,ecd->td", combine, expert_out)
        self._diagnostics = _Live(aux_loss=aux)
        if self.training:
            with torch.no_grad():
                self.aux_loss.copy_(aux.detach())
        return out.reshape(input.shape)
