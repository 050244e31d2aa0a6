"""Tensor-parallel layout of the UNet over the mesh's model axis (port of
reface_tpu/parallel/tp.py).

The rule is the JAX package's, leaf by leaf, on the port's state-dict names
and torch layouts: column-parallel to_q / to_k / to_v and GEGLU's proj_in
(ff.net.0.proj, over the concatenated [value | gate] output), row-parallel
to_out and GEGLU's proj_out (ff.net.2), every conv of at least 128 output
channels sharded over its output channels (the SpatialTransformer's 1x1
proj_in / proj_out among them: 4-D in SD v1, they fall to the conv rule, as
in the JAX package), a Dense of at least 512 outputs over its outputs;
biases and norms replicated, and any sharded dim the axis does not divide
replicated. A JAX Dense kernel is (in, out) and a torch Linear weight
(out, in), a conv kernel HWIO and a torch weight OIHW: the JAX P(None,
model) and P(None, None, None, model) are torch dim 0, P(model, None) dim 1.

Where the JAX package leaves the collectives to GSPMD, shard_params_tp keeps
each rank's shard of the sharded weights and makes the layers compute the
whole UNet's function with Megatron's three autograd Functions over the
model group: `copy` before a column-parallel layer (identity forward, the
input gradient summed over the group), `gather` after it (all-gather
forward, the rank's slice backward) and `reduce` after a row-parallel layer
(all-reduce forward, identity backward; torch.distributed.nn's all_reduce
would sum the gradient again in its backward). A column-parallel layer
gathers its output and adds its whole bias; a row-parallel one takes its
slice of the whole input, and adds its bias once after the reduce. The
self-attention keeps its local heads (heads / n_model) from to_q / to_k /
to_v through the attention kernel into to_out's reduce where a shard is a
whole number of heads; elsewhere (and in the cross-attention, whose split
context picks heads by their global index and whose one-token shortcut runs
to_v then to_out) the projections gather and the layers compute as the
unsharded ones.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from reface_tpu_torch.nn.layers import Conv2d, CrossAttention, Linear
from reface_tpu_torch.ops.attention import multi_head_attention
from reface_tpu_torch.parallel.mesh import MODEL_AXIS, Mesh, all_gather, all_reduce

__all__ = ["unet_tp_spec", "tp_dim", "shard_params_tp", "gather_params_tp",
           "copy_to_model", "gather_from_model", "reduce_from_model"]

# column-parallel (shard output features): torch dim 0 of the weight
_COL_SUFFIXES = ("to_q", "to_k", "to_v", "proj_in")
# row-parallel (shard input features): torch dim 1 of the weight
_ROW_SUFFIXES = ("to_out", "proj_out")


def _jax_parents(name: str) -> tuple[str, str]:
    """(parent, grandparent) of the JAX leaf a torch parameter converts from
    (ckpt/from_jax.py's UNet rule read backwards)."""
    parts = name.split(".")[:-1]
    if parts[-2:] == ["to_out", "0"]:
        return "to_out", parts[-3]
    if parts[-4:] == ["ff", "net", "0", "proj"]:
        return "proj_in", "ff"
    if parts[-3:] == ["ff", "net", "2"]:
        return "proj_out", "ff"
    return parts[-1], parts[-2] if len(parts) > 1 else ""


def unet_tp_spec(name: str, shape) -> tuple:
    """The placement of one UNet parameter, by its state-dict name and torch
    shape: MODEL_AXIS at the sharded dim (e.g. ("model", None) for a
    column-parallel Linear), () when replicated. The JAX unet_tp_spec's
    decision on the converted leaf."""
    shape = tuple(shape)
    if name.split(".")[-1] != "weight" or len(shape) < 2:
        return ()  # biases / norm scales replicated (tiny)
    parent, gparent = _jax_parents(name)
    if parent in _COL_SUFFIXES and len(shape) == 2:
        return (MODEL_AXIS, None)
    if parent in _ROW_SUFFIXES and len(shape) == 2:
        return (None, MODEL_AXIS)
    if gparent == "ff":
        return ()
    # convs: shard output channels when they tile evenly over the axis
    if len(shape) == 4 and shape[0] % 2 == 0 and shape[0] >= 128:
        return (MODEL_AXIS, None, None, None)
    if len(shape) == 2 and shape[0] % 2 == 0 and shape[0] >= 512:
        return (MODEL_AXIS, None)
    return ()


def tp_dim(name: str, shape, n_model: int):
    """The torch dim unet_tp_spec shards over n_model ranks, or None where it
    replicates the leaf or n_model does not divide that dim."""
    spec = unet_tp_spec(name, shape)
    if MODEL_AXIS not in spec:
        return None
    dim = spec.index(MODEL_AXIS)
    return dim if shape[dim] % n_model == 0 else None


# ------------------------------------------------------------ the collectives

class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), ctx.group), None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, rank, dim):
        ctx.rank, ctx.dim, ctx.k = rank, dim, x.shape[dim]
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.rank * ctx.k, ctx.k).contiguous(), None, None, None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_model(x, group):
    return _Copy.apply(x, group)


def gather_from_model(x, group, rank: int, dim: int):
    return _Gather.apply(x, group, rank, dim)


def reduce_from_model(x, group):
    return _Reduce.apply(x, group)


# ------------------------------------------------------------ the layers

class _ColumnLinear(Linear):
    """A Linear holding rows [rank * k, (rank + 1) * k) of its weight."""

    def local(self, x):
        """This rank's output features of an input already copied."""
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt))

    def forward(self, x):
        g, r = self.tp
        y = gather_from_model(self.local(copy_to_model(x, g)), g, r, -1)
        return y if self.bias is None else y + self.bias.to(y.dtype)


class _RowLinear(Linear):
    """A Linear holding columns [rank * k, (rank + 1) * k) of its weight."""

    def from_local(self, x):
        """The whole output from this rank's slice of the input features:
        the partial products summed over the group in fp32, then the bias."""
        g, _ = self.tp
        dt = self.compute_dtype
        y = reduce_from_model(F.linear(x.to(dt), self.weight.to(dt)).float(), g).to(dt)
        return y if self.bias is None else y + self.bias.to(dt)

    def forward(self, x):
        g, r = self.tp
        k = self.weight.shape[1]
        return self.from_local(copy_to_model(x, g).narrow(-1, r * k, k))


class _ColumnConv2d(Conv2d):
    """A Conv2d holding output channels [rank * k, (rank + 1) * k)."""

    def forward(self, x):
        g, r = self.tp
        dt = self.compute_dtype
        y = self._conv_forward(copy_to_model(x, g).to(dt), self.weight.to(dt), None)
        y = gather_from_model(y, g, r, 1)
        return y if self.bias is None else y + self.bias.to(dt)[:, None, None]


class _TPCrossAttention(CrossAttention):
    """The self-attention on this rank's heads where to_q / to_k / to_v are
    column-parallel, to_out row-parallel and the shard is whole heads;
    every other call computes as CrossAttention through the TP layers."""

    def forward(self, x, context=None):
        if context is not None or not self.local_heads:
            return super().forward(x, context)
        g, _ = self.to_out[0].tp
        x = copy_to_model(x, g)
        out = multi_head_attention(self.to_q.local(x), self.to_k.local(x),
                                   self.to_v.local(x), self.heads // self.n_model,
                                   impl=self.attn_impl)
        return self.to_out[0].from_local(out)


def _unet(modules):
    return modules.unet if hasattr(modules, "unet") else modules


@torch.no_grad()
def shard_params_tp(modules, mesh: Mesh):
    """Shard the UNet of `modules` (a SwapModules, or a UNetModel) over the
    mesh's model axis in place: each sharded weight keeps this rank's shard
    (the same Parameter, its `tp_dim` set), and its layer computes the
    whole layer's function. The other towers stay replicated. Returns
    `modules`."""
    n, r, group = mesh.n_model, mesh.model_rank, mesh.model_group
    if n == 1:
        return modules
    unet = _unet(modules)
    if unet.config.quant != "none":
        raise ValueError("tensor parallelism runs the UNet with quant='none'")
    for mod_name, mod in unet.named_modules():
        if type(mod) not in (Linear, Conv2d):
            continue
        w = mod.weight
        dim = tp_dim(f"{mod_name}.weight", w.shape, n)
        if dim is None:
            continue
        k = w.shape[dim] // n
        w.data = w.data.narrow(dim, r * k, k).clone()
        w.tp_dim = dim
        mod.tp = (group, r)
        mod.__class__ = {(Linear, 0): _ColumnLinear, (Linear, 1): _RowLinear,
                         (Conv2d, 0): _ColumnConv2d}[(type(mod), dim)]
    for mod in unet.modules():
        if type(mod) is CrossAttention:
            mod.__class__ = _TPCrossAttention
            mod.n_model = n
            mod.local_heads = (
                all(type(p) is _ColumnLinear and p.bias is None
                    for p in (mod.to_q, mod.to_k, mod.to_v))
                and type(mod.to_out[0]) is _RowLinear and mod.heads % n == 0)
    return modules


@torch.no_grad()
def gather_params_tp(modules, mesh: Mesh, grads: bool = False) -> dict:
    """The whole UNet's state dict (the unsharded names and shapes) from
    the ranks' shards; with grads=True its parameters' gradients instead
    (None where a parameter has none). Every rank of the model group calls
    it, and gets the same."""
    unet = _unet(modules)
    out = {}
    if grads:
        items = [(k, p, p.grad) for k, p in unet.named_parameters()]
    else:
        params = dict(unet.named_parameters())
        items = [(k, params.get(k), t) for k, t in unet.state_dict(keep_vars=True).items()]
    for name, p, t in items:
        dim = getattr(p, "tp_dim", None)
        if t is not None:
            t = t.detach()
            if dim is not None:
                t = all_gather(t, mesh.model_group, dim)
        out[name] = t
    return out
