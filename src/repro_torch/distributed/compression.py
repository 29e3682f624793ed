"""int8 gradient compression with error feedback (the counterpart of
``repro.distributed.compression``).

* ``quantize`` / ``dequantize``: symmetric int8 in blocks of ``block``
  values, one f32 scale (``max |x| / 127``) a block; values are divided by
  ``max(scale, 1e-12)`` and rounded half to even (``torch.round``, as
  ``jnp.round``), so the int8 values and scales equal the reference's bit
  for bit on the same input.
* ``compress_decompress_with_feedback``: the one-device path of the train
  step; it quantizes each gradient leaf plus its carried error and carries
  the new quantization error to the next step.

* ``compressed_psum``: the collective, an all-reduce-MEAN over a process
  group with an int8 wire format, decomposed as the reference's: pad and
  split into one chunk a process, quantize, all-to-all of the values and
  the scales, dequantize and average each chunk over the processes,
  quantize that chunk, all-gather, dequantize.  As in the reference, the
  train step does not call it (its int8 path quantizes the already-reduced
  gradients); it stands on its own.  On a gloo group the int8 buffers cross
  to the host and back explicitly (``launch.mesh``'s collectives), NCCL
  keeps them on the card; either way the result is the same.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.training import tree as T


def quantize(x: torch.Tensor, block: int = 256):
    """x (f32, any shape) -> (int8 values (n_blocks, block), f32 scales
    (n_blocks,), the number of values)."""
    flat = x.reshape(-1)
    n = flat.numel()
    pad = (-n) % block
    if pad:
        flat = F.pad(flat, (0, pad))
    blocks = flat.view(-1, block)
    scale = blocks.abs().amax(dim=1, keepdim=True) / 127.0
    q = torch.clamp(torch.round(blocks / torch.clamp(scale, min=1e-12)), -127, 127)
    return q.to(torch.int8), scale[:, 0], n


def dequantize(q: torch.Tensor, scale: torch.Tensor, n: int, shape) -> torch.Tensor:
    vals = q.float() * scale[:, None]
    return vals.reshape(-1)[:n].reshape(shape)


def compress_decompress_with_feedback(grads, ef_state, placements=None):
    """Quantize and dequantize each leaf of ``grads`` plus its error
    feedback; returns (the dequantized grads, the new error feedback).

    A layer stack (a list) is ONE leaf of the reference, quantized as one
    flat array: its blocks of ``block`` values run across layer boundaries,
    as they do over the reference's stacked array.

    ``placements`` (the leaves' ``sharding.Placement`` objects, on a
    ``"model"`` axis above 1): ``grads`` and ``ef_state`` hold this
    process's pieces; each split leaf's gradient and error feedback are
    gathered whole over ``"model"`` (a collective), quantized as the whole
    leaf, and this process's pieces of both results returned."""
    if ef_state is None:
        ef_state = T.tree_map(lambda g: torch.zeros_like(g, dtype=torch.float32), grads)
    if placements is None:
        placements = T.tree_map(lambda g: None, grads)

    def whole(x, p):
        return x if p is None else p.gather(x)

    def piece(x, p):  # in a storage of its own: the whole leaf is freed
        return x if p is None or not p.split else p.piece(x).clone(
            memory_format=torch.contiguous_format)

    def one(g, e, p):
        if isinstance(g, dict):
            out = {k: one(g[k], e[k], p[k]) for k in g}
            return {k: o[0] for k, o in out.items()}, {k: o[1] for k, o in out.items()}
        if isinstance(g, list):
            g32 = torch.stack([whole(x.float(), pl) for x, pl in zip(g, p)])
            deq, err = _quantized(g32, torch.stack([whole(x, pl) for x, pl in zip(e, p)]))
            return ([piece(x, pl) for x, pl in zip(deq.unbind(0), p)],
                    [piece(x, pl) for x, pl in zip(err.unbind(0), p)])
        deq, err = _quantized(whole(g.float(), p), whole(e, p))
        return piece(deq, p), piece(err, p)

    return one(grads, ef_state, placements)


def _quantized(g32: torch.Tensor, e: torch.Tensor):
    """(dequantize(quantize(g32 + e)), the new error) of one whole leaf."""
    g32 = g32 + e
    q, s, n = quantize(g32)
    deq = dequantize(q, s, n, g32.shape)
    return deq, g32 - deq


def compressed_psum(x: torch.Tensor, mesh, block: int = 256) -> torch.Tensor:
    """The mean of ``x`` over the processes of ``mesh``'s group (a
    ``launch.mesh.Mesh``) with int8 on the wire; ``x`` itself when the
    group has one member.  Every process passes the same shape.  On a mesh
    with a ``"model"`` axis above 1 the mean runs over the other axes (the
    data-parallel replicas of this process's slice)."""
    from repro_torch.launch import mesh as mesh_mod

    axis = None  # the data-parallel replicas: every process, or all but "model"
    if mesh.shape.get("model", 1) > 1:
        axis = tuple(a for a in mesh.axis_names if a != "model")
    n_dev = (mesh if axis is None else mesh.sub(*axis)).world_size
    if n_dev == 1:
        return x
    shape = x.shape
    flat = x.reshape(-1)
    n = flat.numel()
    pad = (-n) % (n_dev * block)
    if pad:
        flat = F.pad(flat, (0, pad))
    q, s, _ = quantize(flat, block)
    q = q.view(n_dev, -1, block)
    s = s.view(n_dev, -1)
    # exchange: process i receives chunk i from every peer
    q_x = mesh_mod.all_to_all(mesh, q, axis=axis)
    s_x = mesh_mod.all_to_all(mesh, s, axis=axis)
    vals = q_x.float() * s_x[..., None]  # (n_dev, blocks, block)
    q2, s2, _ = quantize(vals.mean(dim=0), block)
    q_all = mesh_mod.all_gather(mesh, q2, axis=axis)  # (n_dev, blocks, block)
    s_all = mesh_mod.all_gather(mesh, s2, axis=axis)
    out = (q_all.float() * s_all[..., None]).reshape(-1)
    return out[:n].reshape(shape)
