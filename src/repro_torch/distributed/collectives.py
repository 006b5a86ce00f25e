"""Distributed-optimization collectives on ``torch.distributed``.

Port of ``repro.distributed.collectives``:

* ``compressed_psum`` — int8-quantized gradient all-reduce with error
  feedback. The residual (quantization error) is carried into the next
  round, so the compression is unbiased over time (EF-SGD). The reference
  models the int8 wire as quantize-then-sum (an f32 sum of the
  dequantized values); so does the port, which has no int8 wire format.
* ``sequence_parallel_softmax_combine`` — the log-sum-exp merge for
  attention over a sequence-sharded KV cache.

Each function takes a process group where the reference takes a mesh axis
name: ``mesh.get_group(axis)`` of a ``DeviceMesh`` is that axis's group
for this rank. The reference's ``TrainConfig.grad_compression`` is read
by neither train loop.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def int8_quantize(x, axis=None):
    """Symmetric per-tensor int8 quantization. Returns (q, scale)."""
    amax = torch.max(torch.abs(x))
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def compressed_psum(x, group=None, residual=None):
    """int8 all-reduce with error feedback over ``group``.

    Returns (mean-reduced x (approx), new residual): quantize, dequantize,
    carry ``x - deq``, then the all-reduce SUM of ``deq`` divided by the
    group's size.
    """
    if residual is not None:
        x = x + residual
    q, scale = int8_quantize(x)
    qf = q.to(torch.float32)
    deq = qf * scale
    # error feedback carry x - q·scale, rounded once (a fused
    # multiply-add), as XLA fuses the reference's x - deq
    new_residual = torch.addcmul(x, qf, scale, value=-1)
    n = dist.get_world_size(group)
    summed = deq.clone()
    dist.all_reduce(summed, op=dist.ReduceOp.SUM, group=group)
    return summed / n, new_residual


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _unflatten(tree, it):
    if isinstance(tree, dict):
        return {k: _unflatten(v, it) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_unflatten(v, it) for v in tree]
    return next(it)


def make_compressed_grad_allreduce(mesh, axis_name: str = "data"):
    """Tree-wise compressed all-reduce over ``mesh``'s ``axis_name`` group:
    ``allreduce(grads, residuals) -> (grads, residuals)``, one
    ``compressed_psum`` per leaf (each rank's own gradient tensors, as the
    reference's under ``shard_map``)."""
    group = mesh.get_group(axis_name)

    def allreduce(grads, residuals):
        outs = [compressed_psum(g, group, r)
                for g, r in zip(_leaves(grads), _leaves(residuals))]
        new_g = _unflatten(grads, iter([o[0] for o in outs]))
        new_r = _unflatten(grads, iter([o[1] for o in outs]))
        return new_g, new_r

    return allreduce


def sequence_parallel_softmax_combine(m_local, l_local, o_local, group=None):
    """Merge per-shard (max, sumexp, weighted-V) attention partials.

    m, l: (..., 1); o: (..., D). The flash-decoding cross-shard reduction:
    m* = max over shards; l* = Σ l·exp(m−m*); o* = Σ o·exp(m−m*)/l*.
    """
    m_global = m_local.clone()
    dist.all_reduce(m_global, op=dist.ReduceOp.MAX, group=group)
    corr = torch.exp(m_local - m_global)
    l_global = l_local * corr
    o_global = o_local * corr
    dist.all_reduce(l_global, op=dist.ReduceOp.SUM, group=group)
    dist.all_reduce(o_global, op=dist.ReduceOp.SUM, group=group)
    return o_global / torch.clamp(l_global, min=1e-30)
