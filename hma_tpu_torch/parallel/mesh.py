"""Device mesh (counterpart of hma_tpu/parallel/mesh.py), on torch's
`DeviceMesh` with `hma_tpu`'s axes ("dp", "fsdp", "tp", "sp"), one process
a card.

The data axes are "dp" and "fsdp", as `hma_tpu`'s DATA_AXES: the batch's
rows split over dp * fsdp ranks in dp-major order (each rank's
`distributed.local_slice`, the counterpart of `batch_sharding`), and the
train step's loss denominators, gradients and metrics are summed over them.
Under "dp" alone parameters and optimizer state are replicated and the
step sums the gradients itself. Under "fsdp" (`shard_model`) they are
sharded by torch's FSDP2 (`fully_shard`) after `param_spec`, `hma_tpu`'s
rule; as HSDP (replicated over "dp", sharded over "fsdp") when both axes
are above 1. FSDP2 gathers a block's parameters whole for its forward and
backward, so the kernels read whole parameters as before, and reduces the
gradients over both axes.

Under "tp" (`tensor_parallel.split_model`, `tp_dim`) the attention heads
and the MLP features are split over the tp ranks Megatron-style, each rank
holding its part of every split parameter as a plain tensor. Under "sp"
(`sequence_parallel.enable`) the model's trunk runs on the rank's tokens of
every frame, its spatial attention through an all-to-all to whole frames
of H / sp heads, and the parameters stay whole. The ranks of one tp or sp
group share their data index: they load the same rows and draw the same
masks and noise (`distributed.data_index`). `shard_model` composes them:
tp-local parameters first, sp on the trunk, then FSDP2 over "fsdp" on each
tp rank's local tensors. The mesh's rank order is (dp, fsdp, tp, sp)
row-major, as `hma_tpu`'s devices are.

Where `hma_tpu` builds a mesh over a subset of the devices when the factors
ask for fewer, the port raises: the factors must fill the world exactly.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import DTensor, Shard

from hma_tpu_torch.parallel import distributed

AXES = ("dp", "fsdp", "tp", "sp")
FSDP_MIN_SIZE = 2**16  # `hma_tpu`'s param_spec shards parameters of this many elements up
# hma_tpu's param_spec: the layers whose output features split over "tp"
# (kernel (..., in, out) on its last dimension), those whose input features
# do (on its second last), and embedding tables on their feature dimension
TP_COLUMN = ("qkv", "fc1", "to_q", "to_k", "to_v", "ada_fc1", "ada_fc2")
TP_ROW = ("proj", "fc2", "linear_out", "out_x_proj", "out")
# the root model's methods that read its parameters outside `forward`: FSDP2
# gathers the root's parameters around each (the rollouts' entry points)
ROOT_METHODS = ("compute_logits", "frame_logits", "window_logits", "compute_latents",
                "frame_latents", "sample_tokens", "sample_actions")


def check_factors(dp: Optional[int] = None, fsdp: int = 1, tp: int = 1,
                  sp: int = 1, world: Optional[int] = None) -> int:
    """The dp degree of (dp, fsdp, tp, sp) over `world` ranks (default: the
    process group's): dp defaults to world // (fsdp * tp * sp), as in
    `hma_tpu`. Raises for factors that ask for more or fewer ranks than
    there are (fsdp, tp or sp above 1 in one process among them)."""
    world = distributed.process_count() if world is None else world
    dp = world // (fsdp * tp * sp) if dp is None else dp
    if dp < 1 or dp * fsdp * tp * sp != world:
        raise ValueError(f"mesh (dp {dp}, fsdp {fsdp}, tp {tp}, sp {sp}) needs "
                         f"{max(dp, 1) * fsdp * tp * sp} processes; the world has "
                         f"{world}: launch one process a card with torchrun")
    return dp


def make_mesh(dp: Optional[int] = None, fsdp: int = 1, tp: int = 1,
              sp: int = 1) -> DeviceMesh:
    """A (dp, fsdp, tp, sp) DeviceMesh over every rank of the process group,
    registered as this process's mesh (`use_mesh`). Raises without a
    process group."""
    dp = check_factors(dp, fsdp, tp, sp)
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call "
                           "init_distributed (or launch with torchrun) first")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return use_mesh(init_device_mesh(device_type, (dp, fsdp, tp, sp), mesh_dim_names=AXES))


def use_mesh(mesh: DeviceMesh) -> DeviceMesh:
    """Register `mesh` as this process's: `distributed`'s data index, data
    count and data group are then the mesh's data axes'. Returns it."""
    model_parallel = mesh["tp"].size() * mesh["sp"].size()
    distributed.set_data_axes(data_group(mesh), model_parallel)
    return mesh


def data_group(mesh: DeviceMesh):
    """The process group of the data axes ("dp", "fsdp") flattened: the
    ranks that share this rank's tp and sp index (every rank with tp and
    sp at 1)."""
    if mesh["tp"].size() * mesh["sp"].size() == 1:
        return dist.group.WORLD
    if not hasattr(mesh, "_hma_data_group"):
        mesh._hma_data_group = mesh["dp", "fsdp"]._flatten("dp_fsdp").get_group()
    return mesh._hma_data_group


def tp_group(mesh: DeviceMesh):
    """The process group of the mesh's "tp" axis: the ranks that share this
    rank's data index and split its heads and features."""
    return mesh["tp"].get_group()


def sp_group(mesh: DeviceMesh):
    """The process group of the mesh's "sp" axis: the ranks that share this
    rank's data index and tp index and split its tokens."""
    return mesh["sp"].get_group()


def grad_group(mesh: DeviceMesh):
    """The process group of the data and sp axes ("dp", "fsdp", "sp")
    flattened: the ranks that share this rank's tp index, over which one sum
    gives a model that FSDP2 does not shard, under sp, one process's
    gradients (`sequence_parallel`)."""
    if not hasattr(mesh, "_hma_grad_group"):
        mesh._hma_grad_group = mesh["dp", "fsdp", "sp"]._flatten("dp_fsdp_sp").get_group()
    return mesh._hma_grad_group


def default_mesh_factors(n: int) -> tuple[int, int, int, int]:
    """`hma_tpu`'s (dp, fsdp, tp, sp) factorisation of n devices (sp 2 from
    8, then tp 2 from 4, then fsdp 2 from 2)."""
    sp = 2 if n % 8 == 0 and n >= 8 else 1
    rem = n // sp
    tp = 2 if rem % 2 == 0 and rem >= 4 else 1
    rem //= tp
    fsdp = 2 if rem % 2 == 0 and rem >= 2 else 1
    dp = rem // fsdp
    return dp, fsdp, tp, sp


def tp_dim(parent: str, leaf: str, jax_shape, tp: int) -> Optional[int]:
    """The dimension of `hma_tpu`'s leaf `parent/leaf` (its flax shape) that
    its param_spec splits over "tp", or None where it replicates: a
    column-split kernel's last, a row-split kernel's second last, an
    embedding table's last, each where tp (above 1) divides it."""
    jax_shape = tuple(jax_shape)
    dim = None
    if leaf == "kernel" and len(jax_shape) >= 2:
        dim = -1 if parent in TP_COLUMN else (-2 if parent in TP_ROW else None)
    elif leaf == "embedding" and len(jax_shape) == 2:
        dim = -1
    if dim is None or tp <= 1 or jax_shape[dim] % tp:
        return None
    return len(jax_shape) + dim


def param_spec(shape, fsdp: int, transposed: bool = False,
               taken: Optional[int] = None) -> Optional[int]:
    """The dimension `hma_tpu`'s param_spec shards over "fsdp", or None where
    it replicates: the largest dimension that `fsdp` divides (the first of
    equals) of a parameter of at least FSDP_MIN_SIZE elements, other than
    the one tp splits (`taken`, or None). `shape` is the whole parameter's.
    `transposed`: the parameter is an nn.Linear weight (out, in), which
    `hma_tpu` holds as its kernel (in, out); the rule then runs on the
    kernel's shape and the dimensions taken and returned are the weight's."""
    shape = tuple(shape)
    if fsdp <= 1 or math.prod(shape) < FSDP_MIN_SIZE:
        return None
    jax_shape = shape[::-1] if transposed else shape
    for i in sorted(range(len(jax_shape)), key=lambda i: -jax_shape[i]):
        dim = len(shape) - 1 - i if transposed else i
        if dim != taken and jax_shape[i] % fsdp == 0:
            return dim
    return None


def shard_dim(module: nn.Module, leaf: str, p: torch.Tensor, fsdp: int,
              part=None) -> int:
    """The dimension FSDP2 shards parameter `leaf` of `module` on: the one
    `param_spec` names, on the whole shape with tp's dimension taken where
    tp splits it (`part`, a `tensor_parallel.Part`). FSDP2 cannot leave one
    parameter of a group replicated, so where `hma_tpu` replicates (under
    FSDP_MIN_SIZE elements, or no dimension divides) the port shards the
    last dimension (unevenly where it must). That moves no number, and it
    keeps a domain-stacked table's rows (dimension 0) whole on every rank."""
    transposed = isinstance(module, nn.Linear) and leaf == "weight" and p.ndim == 2
    shape, taken = (p.shape, None) if part is None else (part.shape, part.dim)
    dim = param_spec(shape, fsdp, transposed, taken)
    return p.ndim - 1 if dim is None else dim


def _fsdp_modules(model: nn.Module):
    from hma_tpu_torch.models.diffloss import DiffLoss
    from hma_tpu_torch.models.st_transformer import STBlock

    blocks = [(m, ("frame_step", "window_step")) for m in model.modules()
              if isinstance(m, STBlock)]
    heads = [(m, ("loss", "sample")) for m in model.modules() if isinstance(m, DiffLoss)]
    return blocks + heads + [(model, tuple(n for n in ROOT_METHODS if hasattr(model, n)))]


def shard_model(model: nn.Module, mesh: DeviceMesh) -> nn.Module:
    """Shard `model`'s parameters over the mesh, in place (the counterpart
    of `make_param_shardings` and `device_put`): first split over "tp"
    (`tensor_parallel.split_model`, where tp is above 1), the trunk set to
    run on the rank's tokens where sp is above 1 (`sequence_parallel.
    enable`), then over "fsdp" with FSDP2 on each tp rank's local tensors
    (not at all where fsdp is 1 and tp or sp above; a mesh of no tp, no sp
    and fsdp 1 is one FSDP2 group a rank):
    one `fully_shard` group per STBlock and per diffusion head (`DiffLoss`),
    then the root with the rest. Each parameter is Shard(`shard_dim`); with
    dp above 1 the groups are HSDP over ("dp", "fsdp"). The methods that
    read a group's parameters besides `forward` (the blocks' cached steps,
    the heads' loss and sampler, the root's rollout entry points) gather
    them too. The gradients are summed over the data axes, not averaged:
    the train step's loss is already this rank's share of the global-batch
    mean. Returns `model`, whose parameters are then DTensors under fsdp
    (on the "fsdp" sub-mesh of this rank's tp index)."""
    from torch.distributed.fsdp import fully_shard, register_fsdp_forward_method

    from hma_tpu_torch.parallel import sequence_parallel
    from hma_tpu_torch.parallel.tensor_parallel import group_of, split_model

    if mesh["tp"].size() > 1 and getattr(model, "tp", None) is None:
        split_model(model, group_of(tp_group(mesh)))
    fsdp = mesh["fsdp"].size()
    if mesh["sp"].size() > 1 and getattr(model, "sp", None) is None:
        sequence_parallel.enable(model, group_of(sp_group(mesh)),
                                 grad_group(mesh) if fsdp == 1 else None)
    if fsdp == 1 and mesh["tp"].size() * mesh["sp"].size() > 1:
        return model
    parts = getattr(model, "tp_parts", {})
    dims = {id(p): shard_dim(mod, leaf, p, fsdp, parts.get(f"{name}.{leaf}" if name else leaf))
            for name, mod in model.named_modules()
            for leaf, p in mod.named_parameters(recurse=False)}
    shard_mesh = mesh["dp", "fsdp"] if mesh["dp"].size() > 1 else mesh["fsdp"]
    for mod, methods in _fsdp_modules(model):
        fully_shard(mod, mesh=shard_mesh, shard_placement_fn=lambda p: Shard(dims[id(p)]))
        for name in methods:
            register_fsdp_forward_method(mod, name)
        mod.set_gradient_divide_factor(1.0)
        if hasattr(mod, "set_force_sum_reduction_for_comms"):  # gloo has no PREMUL_SUM
            mod.set_force_sum_reduction_for_comms(True)
    return model


def local(t: torch.Tensor) -> torch.Tensor:
    """This rank's shard of a DTensor (its storage, written in place by an
    update), or `t` itself."""
    return t.to_local() if isinstance(t, DTensor) else t


def shard_slices(t: torch.Tensor) -> tuple:
    """The index of this rank's shard of DTensor `t` in its global tensor:
    one slice a dimension (every dimension whole for a plain tensor)."""
    if not isinstance(t, DTensor):
        return tuple(slice(None) for _ in t.shape)
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    shape, offset = compute_local_shape_and_global_offset(t.shape, t.device_mesh,
                                                          t.placements)
    return tuple(slice(o, o + s) for s, o in zip(shape, offset))


def shard_group(t: torch.Tensor):
    """The process group over which DTensor `t` is sharded (its mesh's last
    dimension: "fsdp"), or None for a plain tensor."""
    return t.device_mesh.get_group(t.device_mesh.ndim - 1) if isinstance(t, DTensor) else None


def full(t: torch.Tensor) -> torch.Tensor:
    """The whole tensor: a DTensor gathered (a collective: every rank of its
    mesh calls it), anything else as it is."""
    return t.full_tensor() if isinstance(t, DTensor) else t
