"""The local epoch and the fused Eq. 2 wire step, ported from
``repro/core/engine.py``.

``make_epoch_fn`` is the port's counterpart of the JAX vmapped epoch: an
explicit loop over the K participants. Each step takes
``leaf[k].detach().requires_grad_()`` views of participant k's slot,
computes the loss and ``torch.autograd.grad``, and writes the optimizer
update back into the stacked storage IN PLACE. It holds one
participant's gradients at a time, where the vmap holds K; the step
losses stay on the device.

``make_fused_compressed_average`` is the simulation-path (``mesh=None``)
Eq. 2 fast path of ``FlatFusedIntN``: the stacked params are flattened
into one ``(K, N_pad)`` f32 buffer and ONE fused quantize -> average ->
dequantize pass (K3, or K4 with error feedback) computes the mean, which
is written back into the stacked params in place.

The fused round engine (one captured round, chunked epochs, the
divergence gate), the ragged-shard batch mask and the liveness row are
still to port (ROADMAP.md).
"""
from __future__ import annotations

import torch

from repro_torch.core import flatbuf
from repro_torch.kernels import ops as kops
from repro_torch.tree import leaves, tree_map, unflatten_like


def init_stacked_opt(opt, stacked):
    """Per-participant optimizer state stacked along K (the counterpart
    of ``jax.vmap(opt.init)``)."""
    K = leaves(stacked)[0].shape[0]
    per = [opt.init(tree_map(lambda t, _k=k: t[_k], stacked))
           for k in range(K)]
    return tree_map(lambda *xs: torch.stack(xs), per[0], *per[1:])


def make_epoch_fn(loss_fn, opt):
    """One local epoch for all K participants.

    Returns ``epoch_fn(stacked_params, opt_state, batches, lr) ->
    (stacked_params, opt_state, per-participant mean loss (K,))`` where
    ``batches`` is a tree of ``(K, n_batches, ...)`` tensors. Params and
    optimizer state are updated in place (and returned)."""
    def epoch_fn(stacked, opt_state, batches, lr):
        K = leaves(stacked)[0].shape[0]
        n_batches = leaves(batches)[0].shape[1]
        means = []
        for k in range(K):
            slot = tree_map(lambda t, _k=k: t[_k], stacked)
            ostate = tree_map(lambda t, _k=k: t[_k], opt_state)
            step_losses = []
            for b in range(n_batches):
                params = tree_map(lambda t: t.detach().requires_grad_(), slot)
                batch = tree_map(lambda t, _k=k, _b=b: t[_k, _b], batches)
                loss, _ = loss_fn(params, batch)
                grads = unflatten_like(params, torch.autograd.grad(
                    loss, leaves(params)))
                with torch.no_grad():
                    upd, new_ostate = opt.update(grads, ostate, params, lr)
                    del grads
                    for dst, u in zip(leaves(slot), leaves(upd)):
                        dst.copy_((dst.float() + u).to(dst.dtype))
                    del upd
                    for dst, src in zip(leaves(ostate), leaves(new_ostate)):
                        dst.copy_(src)
                step_losses.append(loss.detach())
            means.append(torch.stack(step_losses).mean())
        return stacked, opt_state, torch.stack(means)

    return epoch_fn


def make_fused_compressed_average(*, block=256, bits=8, mesh=None,
                                  axis="pod", weighted=False,
                                  stateful=False):
    """Eq. 2 fast path: quantized wire emulation + averaging as ONE pass.

    Returns ``average(stacked)`` (uniform), ``average_w(stacked, wrow)``
    (example-count-weighted, via K1/K2 and one einsum) or, with
    ``stateful=True``, the error-feedback forms taking the ``(K, N_pad)``
    residual last and returning ``(stacked, new_residual)``. The mean is
    written into ``stacked`` in place. ``mesh`` (the pod path) is still to
    port."""
    if mesh is not None:
        raise NotImplementedError(
            "the pod-mesh wire path is not yet ported, see ROADMAP.md")

    def _flat(stacked):
        layout = flatbuf.make_layout(stacked, block=block)
        return layout, flatbuf.flatten(stacked, layout)

    def _weighted_mean(y, wrow):
        q, scale, shape = kops.quantize_blockwise(y, block=block, bits=bits)
        dq = kops.dequantize_blockwise(q, scale, shape, bits=bits)
        return torch.einsum("k,kn->n", wrow.float(), dq), dq

    if stateful and weighted:
        @torch.no_grad()
        def average_w_ef(stacked, wrow, residual):
            layout, buf = _flat(stacked)
            y = buf.add_(residual)
            mean, dq = _weighted_mean(y, wrow)
            return (flatbuf.unflatten_mean(mean, layout, out=stacked),
                    y.sub_(dq))
        return average_w_ef

    if stateful:
        @torch.no_grad()
        def average_ef(stacked, residual):
            layout, buf = _flat(stacked)
            mean, new_res = kops.quant_avg_dequant_ef(buf, residual,
                                                      block=block, bits=bits)
            del buf
            return (flatbuf.unflatten_mean(mean, layout, out=stacked),
                    new_res)
        return average_ef

    if weighted:
        @torch.no_grad()
        def average_w(stacked, wrow):
            layout, buf = _flat(stacked)
            mean, _ = _weighted_mean(buf, wrow)
            return flatbuf.unflatten_mean(mean, layout, out=stacked)
        return average_w

    @torch.no_grad()
    def average(stacked):
        layout, buf = _flat(stacked)
        mean = kops.quant_avg_dequant(buf, block=block, bits=bits)
        del buf
        return flatbuf.unflatten_mean(mean, layout, out=stacked)
    return average
