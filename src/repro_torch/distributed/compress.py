"""Gradient compression for data parallelism across slow links: the JAX
package's `repro.distributed.compress` over `torch.distributed`.

Two mechanisms, as in the reference:

  * the gradients' all-reduce in their own dtype (bf16 params give bf16
    gradients: half the wire bytes of f32), which the train step does
    (`distributed.tp.all_reduce_data`);
  * int8 error-feedback all-reduce (`compressed_psum`): a per-tensor
    max-abs scale, stochastic rounding, int8 on the wire (each rank's
    quantised tensor all-gathered, accumulated in int32), and a residual
    the caller carries to the next step (error feedback keeps the
    compression unbiased over steps).

The reference draws its rounding noise from a JAX key; here it comes from
an explicit `torch.Generator`, or is passed in (`noise`), so that a test
can give every rank the noise it wants.
"""

from __future__ import annotations

import torch


def _quantize(x: torch.Tensor, generator: torch.Generator | None = None,
              bits: int = 8, noise: torch.Tensor | None = None
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """(q int8, scale): ``x / scale`` rounded stochastically, ``scale`` the
    max-abs over the largest code (plus 1e-12). The noise is uniform on
    [-0.5, 0.5), drawn from `generator` unless given."""
    qmax = 2.0 ** (bits - 1) - 1
    scale = x.abs().max() / qmax + 1e-12
    if noise is None:
        noise = torch.rand(x.shape, generator=generator, dtype=x.dtype,
                           device=x.device) - 0.5
    q = torch.clamp(torch.round(x / scale + noise), -qmax, qmax)
    return q.to(torch.int8), scale


def _group(mesh, axis: str):
    """(process group, size) of `mesh`'s `axis`."""
    if axis == "data":
        return mesh.data_group, mesh.data
    return mesh.group, mesh.tp


def compressed_psum(x: torch.Tensor, mesh, axis: str = "data",
                    residual: torch.Tensor | None = None, bits: int = 8,
                    generator: torch.Generator | None = None,
                    noise: torch.Tensor | None = None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """The int8-quantised mean of the ranks' `x` over `mesh`'s `axis`, with
    error feedback: returns (mean, new residual), where ``x + residual =
    q * scale + new residual``. The quantised tensors travel as int8 and
    are summed in int32 (worlds up to 2^23 ranks are exact); the mean
    takes the ranks' mean scale, as the reference's does."""
    from repro_torch.distributed import tp as TP

    if residual is not None:
        x = x + residual
    x = x.float()
    q, scale = _quantize(x, generator, bits, noise)
    group, n = _group(mesh, axis)
    parts = TP._gather(q, 0, mesh, group=group, n=n).reshape(n, *q.shape)
    total = parts.to(torch.int32).sum(0)
    scale_sum = TP._all_reduce_(scale.reshape(1).clone(), group)[0]
    mean = total.float() * (scale_sum / n) / n
    return mean, x - q.float() * scale


def compressed_allreduce_tree(grads: dict, mesh, axis: str = "pod",
                              residuals: dict | None = None, bits: int = 8,
                              generator: torch.Generator | None = None
                              ) -> tuple[dict, dict | None]:
    """`compressed_psum` leaf by leaf over `axis` ({name: tensor} trees,
    the residuals threaded through; each leaf's noise drawn in turn from
    `generator`). The grads must already be reduced over the other axes.
    Where the mesh has no `axis` (the port's meshes have "data" and
    "model"; the reference's pods have none either) the grads and
    residuals come back unchanged, as the reference returns them."""
    if mesh is None or axis not in mesh.axis_names:
        return grads, residuals
    residuals = residuals or {}
    out, res = {}, {}
    for name, g in grads.items():
        out[name], res[name] = compressed_psum(
            g, mesh, axis, residuals.get(name), bits, generator)
    return out, res


def wire_bytes_saved(grads: dict, bits: int = 8, from_bits: int = 16
                     ) -> float:
    """Bytes the compressed wire saves on `grads` ({name: tensor}) against
    `from_bits` a value."""
    return sum(g.numel() for g in grads.values()) * (from_bits - bits) / 8.0
