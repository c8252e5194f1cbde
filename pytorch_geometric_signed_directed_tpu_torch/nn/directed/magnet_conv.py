"""MagNetConv: Chebyshev filter over the scaled magnetic Laplacian.

Counterpart of ``pytorch_geometric_signed_directed_tpu/nn/directed/
magnet_conv.py``.  The original layer runs four propagate
streams, two of which repeat the other two, so the math is two Chebyshev
recurrences:

    S1_k = T_k(L_re) x_re      S2_k = T_k(L_im) x_im
    out_re = sum_k (S1_k - S2_k) W_k + b
    out_im = sum_k (S1_k + S2_k) W_k + b

On the sparse tiers both recurrences run in lockstep through the fused
operator pair, one lane-stacked apply per order.  With frozen operators
(a MagneticPair whose ``dual`` is set: the kernel tier, the segment tier
or a sharded pair) the layer is one autograd Function, ``_FusedConv``,
on lane-stacked state ``[x_re | x_im]`` ([N, 2F]):

  * the applies give the terms; a term's ``view(2N, F)`` holds the real
    row of node n at 2n and the imaginary one at 2n+1, so
    ``sum_k T_k.view(2N, F) @ W_k`` is ``[o1 | o2]`` lane-stacked, with
    no copy;
  * the last term is never formed: ``T_K = 2 P T_{K-1} - T_{K-2}`` goes
    into the weights (``P T_{K-1}`` by ``2 W_K``, ``W_{K-2} - W_K``);
  * one kernel (``ops/cuda/complex_epilogue``) adds the complex combine,
    the bias and, inside a model with the activation, the complex ReLU;
  * the backward is written by hand: the weight gradients from the saved
    terms, the input's gradient by the recurrence run backwards through
    the transposed pair (Clenshaw's order), with the adds taken into the
    products' ``beta`` and the weight differences.

Trainable q and pairs without a dual (the dense and bsr tiers) take the
generic recurrence below, with the K+1 weight applies one float32
einsum.  With ``trainable_q`` the operators come from a MagneticTemplate
for the clipped phase: through ``template_dual_apply`` on the kernel
tier (flat, split, streamed or sharded), through
``template_propagators`` on the dense and segment tiers.
"""
from typing import List, Optional, Tuple

import torch
from torch import nn

from ... import instrument
from ...device import DeviceLike, resolve_device
from ...ops.cuda.complex_epilogue import (complex_epilogue,
                                          complex_epilogue_backward)
from ...ops.spmm import (DualPropagator, Propagator, _dual_forward_stacked,
                         dual_spmm_stacked)
from ...spectral.magnetic import (
    MagneticPair,
    MagneticTemplate,
    template_dual_apply,
    template_propagators,
)
from ..inits import glorot, zeros
from .complex_relu import complex_relu


def chebyshev_stack(P: Propagator, x: torch.Tensor, K: int) -> torch.Tensor:
    """[K+1, N, F] stack of Chebyshev polynomials T_k(P) x."""
    ts = [x]
    if K >= 1:
        ts.append(P(x))
    for _ in range(2, K + 1):
        ts.append(2.0 * P(ts[-1]) - ts[-2])
    return torch.stack(ts)


def dual_chebyshev_stacks(D: DualPropagator, x_a: torch.Tensor,
                          x_b: torch.Tensor, K: int,
                          apply=dual_spmm_stacked):
    """Both Chebyshev stacks through the fused pair.  The recurrence state
    stays lane-stacked [N, 2F] throughout; the split back into the two
    streams happens once at the end."""
    s = _dual_chebyshev(D, torch.cat([x_a, x_b], dim=1), K, apply)
    f = x_a.shape[1]
    return s[:, :, :f], s[:, :, f:]


def _dual_chebyshev(D: DualPropagator, x: torch.Tensor, K: int,
                    apply=dual_spmm_stacked) -> torch.Tensor:
    """[K+1, N, 2F] stack of the recurrence on lane-stacked x."""
    ts = [x]
    if K >= 1:
        ts.append(apply(D, ts[0]))
    for _ in range(2, K + 1):
        ts.append(2.0 * apply(D, ts[-1]) - ts[-2])
    return torch.stack(ts)


# Calls of the fused layer since the last reset: forwards (training and
# evaluation) and hand-written backwards, in the counter group
# "magnet_fused".  Not part of ``ops.cuda.launch_counts()``, which counts
# the sparse kernels.
FUSED_CALLS = instrument.counter("magnet_fused", ("forward", "backward"))


def _terms(D: DualPropagator, x: torch.Tensor, K: int) -> List[torch.Tensor]:
    """T_0 .. T_{K-1} of the recurrence, then ``P T_{K-1}``: K applies.
    A T_k with 2 <= k < K is formed in place on its apply's output."""
    ts = [x]
    a = _dual_forward_stacked(D, x)
    for k in range(2, K + 1):
        ts.append(a if k == 2 else a.mul_(2).sub_(ts[-2]))
        a = _dual_forward_stacked(D, ts[-1])
    return ts + [a]


def _term_weights(weight: torch.Tensor, K: int) -> torch.Tensor:
    """The weights of ``_terms``: T_K is formed in them, ``P T_{K-1}`` by
    ``2 W_K`` and ``T_{K-2}`` by ``W_{K-2} - W_K`` (as they are at K=1).
    Built by kernels alone (no device-to-device copy), so an eager epoch
    and its CUDA graph replay run the same kernels."""
    if K == 1:
        return weight
    return torch.cat([weight[:K - 2], weight[K - 2:K - 1] - weight[K:],
                      weight[K - 1:K], 2 * weight[K:]])


def _fused_forward(x: torch.Tensor, weight: torch.Tensor,
                   bias: Optional[torch.Tensor], D: DualPropagator,
                   activation: bool, keep_mask: bool):
    """``(z, mask, terms, cat)``: the layer's lane-stacked output, the
    complex ReLU's mask, the terms and, at narrow input widths, their
    [2N, (K+1)F] concatenation (then the weight products are one GEMM:
    writing an operand no wider than the output costs less than the output
    pass that each further ``addmm`` takes)."""
    K, f, f_out = weight.shape[0] - 1, weight.shape[1], weight.shape[2]
    n = x.shape[0]
    if x.shape[1] != 2 * f:
        raise ValueError(f"lane-stacked input must be [N, {2 * f}], got "
                         f"{tuple(x.shape)}")
    terms = _terms(D, x, K)
    w = _term_weights(weight, K)
    cat = None
    if (K + 1) * f <= f_out:
        cat = torch.cat([t.view(2 * n, f) for t in terms], dim=1)
        y = cat @ w.reshape((K + 1) * f, f_out)
    else:
        y = terms[0].view(2 * n, f) @ w[0]
        for t, w_k in zip(terms[1:], w[1:]):
            y.addmm_(t.view(2 * n, f), w_k)
    z, mask = complex_epilogue(y.view(n, 2 * f_out), bias, activation,
                               keep_mask)
    return z, mask, terms, cat


def _weight_grads(dws: torch.Tensor, K: int) -> torch.Tensor:
    """The weights' gradient from those of ``_term_weights`` (in place)."""
    if K > 1:
        dws[K].mul_(2).sub_(dws[K - 2])
    return dws


def _input_grad(D: DualPropagator, uv: torch.Tensor, weight: torch.Tensor,
                n: int) -> torch.Tensor:
    """The input's gradient: the recurrence run backwards through the
    transposed pair, Clenshaw's order.  With ``G_k = UV W_k^T``,

        dT_K = G_K,   dT_k = G_k + 2 P^T dT_{k+1} - dT_{k+2}   (k >= 1),
        dT_0 = G_0 + P^T dT_1 - dT_2,

    each ``G_k`` added by the ``addmm`` that computes it, onto the
    transposed apply scaled by its ``beta``; ``- dT_K`` goes into the
    weight (``W_{K-2} - W_K`` of ``_term_weights``).  K transposed
    applies."""
    if D.transposed is None:
        raise ValueError("the dual was built with with_transpose=False and "
                         "has no backward")
    K, f = weight.shape[0] - 1, weight.shape[1]
    w = _term_weights(weight, K)
    d, d2 = uv @ weight[K].t(), None         # dT_{k+1}, dT_{k+2}
    for k in range(K - 1, -1, -1):
        p = _dual_forward_stacked(D.transposed, d.view(n, 2 * f))
        p = p.view(2 * n, f).addmm_(uv, w[k].t(), beta=2 if k else 1)
        if k + 2 < K:
            p.sub_(d2)
        d, d2 = p, d
    return d.view(n, 2 * f)


class _FusedConv(torch.autograd.Function):
    """The layer over a frozen dual, lane-stacked in and out; the backward
    by hand (the module docstring)."""

    @staticmethod
    def forward(ctx, x, weight, bias, D, activation):
        z, mask, terms, cat = _fused_forward(x, weight, bias, D, activation,
                                             True)
        ctx.D, ctx.stacked = D, cat is not None
        ctx.save_for_backward(weight, mask,
                              *(terms if cat is None else [cat]))
        return z

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dz):
        FUSED_CALLS["backward"] += 1
        weight, mask, *saved = ctx.saved_tensors
        K, f, f_out = weight.shape[0] - 1, weight.shape[1], weight.shape[2]
        uv, db = complex_epilogue_backward(dz, mask, ctx.needs_input_grad[2])
        n = uv.shape[0]
        uv = uv.view(2 * n, f_out)
        dw = dx = None
        if ctx.needs_input_grad[1]:
            dws = ((saved[0].t() @ uv).view(K + 1, f, f_out) if ctx.stacked
                   else torch.stack([t.view(2 * n, f).t() @ uv
                                     for t in saved]))
            dw = _weight_grads(dws, K)
        if ctx.needs_input_grad[0]:
            dx = _input_grad(ctx.D, uv, weight, n)
        return dx, dw, db, None, None


def fused_conv(x: torch.Tensor, weight: torch.Tensor,
               bias: Optional[torch.Tensor], D: DualPropagator,
               activation: bool) -> torch.Tensor:
    """MagNetConv (and, with ``activation``, the complex ReLU after it) on
    lane-stacked ``x = [x_re | x_im]`` [N, 2F] over the frozen dual ``D``;
    returns ``[out_re | out_im]`` [N, 2F_out].  Without a gradient to take
    it runs the forward alone and keeps no mask."""
    FUSED_CALLS["forward"] += 1
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, weight, bias)):
        return _FusedConv.apply(x, weight, bias, D, activation)
    return _fused_forward(x, weight, bias, D, activation, False)[0]


class MagNetConv(nn.Module):
    """Args mirror the original layer; the forward takes ``lap``, a
    MagneticPair (or a (P_re, P_im) tuple) from ``magnet_propagators``, or
    a MagneticTemplate when ``trainable_q`` is True.

    ``generator`` draws the initial weights (on the CPU); ``device``
    places them (None means "cuda")."""

    def __init__(self, in_channels: int, out_channels: int, K: int,
                 q: float = 0.25, trainable_q: bool = False,
                 normalization: Optional[str] = "sym", bias: bool = True,
                 *, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if K <= 0:
            raise ValueError(f"K must be positive, got {K}")
        device = resolve_device(device)
        self.in_channels, self.out_channels, self.K = (in_channels,
                                                       out_channels, K)
        self.trainable_q, self.normalization = trainable_q, normalization
        self.weight = nn.Parameter(
            glorot((K + 1, in_channels, out_channels), generator).to(device))
        if trainable_q:
            self.q = nn.Parameter(torch.full((1,), q, device=device))
        else:
            self.q = q
        if bias:
            self.bias = nn.Parameter(zeros((out_channels,)).to(device))
        else:
            self.register_parameter("bias", None)

    @instrument.layer("nn.magnet_conv")
    def _stacked(self, z: torch.Tensor, lap,
                 activation: bool = False) -> torch.Tensor:
        """The layer, and the complex ReLU with ``activation``, on
        lane-stacked ``z = [x_re | x_im]``; lane-stacked out.  Over a frozen
        dual one ``fused_conv``; trainable q and pairs without a dual take
        the generic recurrence.  The model's trunk runs its layers through
        this."""
        if not self.trainable_q and isinstance(lap, MagneticPair) \
                and lap.dual is not None:
            return fused_conv(z.contiguous(), self.weight, self.bias,
                              lap.dual, activation)
        real, imag = self._generic(z, lap)
        if activation:
            real, imag = complex_relu(real, imag)
        return torch.cat([real, imag], dim=1)

    def _generic(self, z: torch.Tensor,
                 lap) -> Tuple[torch.Tensor, torch.Tensor]:
        f = self.in_channels
        apply = dual_spmm_stacked
        if self.trainable_q:
            # the original clamps q each forward; min(max(.)) passes half
            # the gradient at a bound, as jnp.clip does (torch.clamp would
            # pass all of it, and q starts at the bound 0.25)
            q = torch.minimum(torch.maximum(self.q, torch.zeros_like(self.q)),
                              torch.full_like(self.q, 0.25))[0]
            if not isinstance(lap, MagneticTemplate):
                raise TypeError("trainable_q needs a MagneticTemplate")
            if lap.mode in ("mxu", "mxu_sharded"):
                dual = lap

                def apply(_D, v):
                    return template_dual_apply(lap, q, v)
            else:
                dual = None
                P_re, P_im = template_propagators(lap, q)
        else:
            P_re, P_im = lap
            dual = lap.dual if isinstance(lap, MagneticPair) else None
        if dual is not None:
            s = _dual_chebyshev(dual, z, self.K, apply)   # [K+1, N, 2F]
            s1, s2 = s[:, :, :f], s[:, :, f:]
        else:
            s1 = chebyshev_stack(P_re, z[:, :f], self.K)  # [K+1, N, F]
            s2 = chebyshev_stack(P_im, z[:, f:], self.K)
        o1 = torch.einsum("knf,kfo->no", s1, self.weight)
        o2 = torch.einsum("knf,kfo->no", s2, self.weight)
        out_real = o1 - o2
        out_imag = o1 + o2
        if self.bias is not None:
            out_real = out_real + self.bias
            out_imag = out_imag + self.bias
        return out_real, out_imag

    def forward(self, x_real: torch.Tensor, x_imag: torch.Tensor,
                lap) -> Tuple[torch.Tensor, torch.Tensor]:
        z = self._stacked(torch.cat([x_real, x_imag], dim=1), lap)
        return z[:, :self.out_channels], z[:, self.out_channels:]
