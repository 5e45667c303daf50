"""Partition rules: parameter path regex -> partition spec, and DTensor
placement on a ``DeviceMesh``.

Counterpart of ``src/repro/distributed/sharding.py``. A spec is the
reference's ``PartitionSpec`` as a plain tuple with one entry a tensor
dim: a mesh dim name, a tuple of names (one tensor dim sharded over
several mesh dims, major to minor) or None (replicated).

Axis roles:

* ``dp``    -- batch data parallelism: ("pod", "data") on the multi-pod
  mesh, ("data",) on one pod;
* ``model`` -- tensor / expert parallelism;
* FSDP      -- for huge archs (``param_count > FSDP_THRESHOLD``) weight
  matrices also shard their *input* dim over "data" (ZeRO-3 style); the
  optimizer moments inherit the parameter specs, so ZeRO-1 comes free.

Every rule is divisibility-guarded: a dim that does not divide its mesh
axis is replicated. Rules describe trailing dims and are right-aligned.
The rules match the JAX package's leaf path (``layout.jax_path``,
``segments/0/attn/wq``), where a segment's layers are stacked on leading
axes; the port keeps one tensor a layer (``layers.3.attn.wq``), and by
right alignment its spec is the stacked spec without the leading stacked
axes.

The reference reads the ambient ``with mesh:``. Here the mesh of a
``DTensor`` takes its place: :func:`maybe_wsc` redistributes a DTensor
to the filtered spec on its own mesh and is the identity on a plain
tensor, as the reference is outside a mesh context. :func:`named` turns
specs into DTensor placements (``Shard(d)`` on each mesh dim the spec
names for tensor dim d, ``Replicate()`` elsewhere) and distributes a
parameter or state tree onto the mesh. :func:`abstract_mesh` is a
device-free stand-in (names and sizes) that the spec functions take
beside a ``DeviceMesh``, so they run at production sizes without a
process group.

KV-cache layout: kv-head counts (8) are below the model-axis size (16),
so decode caches shard their *sequence* dim over "model" (sequence
parallelism for long-context decode).

``torch.distributed.tensor`` is imported inside the functions that place
tensors: the spec logic never needs it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import re
from collections.abc import Mapping

import torch
from torch import nn

from repro_torch import layout
from repro_torch.core import tsmm
from repro_torch.ft import is_dtensor

FSDP_THRESHOLD = 30e9


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """Names and sizes of a mesh, no devices: what the spec functions read
    of a ``DeviceMesh`` (``mesh_dim_names``, ``shape``, ``size()``)."""
    shape: tuple[int, ...]
    mesh_dim_names: tuple[str, ...]

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def size(self) -> int:
        return math.prod(self.shape)


def abstract_mesh(axis_sizes, axis_names) -> AbstractMesh:
    """A device-free mesh for spec logic (the reference's
    ``AbstractMesh((16, 16), ("data", "model"))``)."""
    if len(axis_sizes) != len(axis_names):
        raise ValueError(f"{len(axis_sizes)} sizes for {len(axis_names)} "
                         "axis names")
    return AbstractMesh(tuple(int(s) for s in axis_sizes),
                        tuple(axis_names))


def _names(mesh) -> tuple[str, ...]:
    return tuple(mesh.mesh_dim_names or ())


def _sizes(mesh) -> dict:
    return dict(zip(_names(mesh), mesh.shape))


def dp_axes(mesh) -> tuple[str, ...]:
    """Data-parallel axes of ``mesh``. Shares one derivation with the GEMM
    dispatcher (``tsmm.derive_dp_axes``): conventional names
    ("pod"/"data"/"dp"/"batch"/"replica") when present, otherwise any
    non-model-named axis; a single-axis mesh is always DP."""
    return tsmm.derive_dp_axes(mesh)


def _entry(axes):
    """One spec entry for ``axes``: a lone name stands for itself, as a
    ``PartitionSpec`` canonicalizes a one-name tuple."""
    return axes[0] if isinstance(axes, tuple) and len(axes) == 1 else axes


def _axis_size(mesh, axis) -> int:
    if axis is None:
        return 1
    sizes = _sizes(mesh)
    if isinstance(axis, tuple):
        return math.prod(sizes[a] for a in axis)
    return sizes[axis]


def _guard(mesh, spec: tuple, shape) -> tuple:
    """Replicate any dim that doesn't divide its assigned axis."""
    offset = len(shape) - len(spec)
    padded = (None,) * offset + tuple(spec)
    return tuple(axis if axis is not None
                 and dim % _axis_size(mesh, axis) == 0 else None
                 for dim, axis in zip(shape, padded))


def param_rules(cfg, mesh, fsdp: bool | None = None):
    """Ordered (regex, trailing-dims spec) rules, the reference's every
    one (MoE, MLA, Mamba2 and RWKV6 included)."""
    if fsdp is None:
        fsdp = cfg.param_count() > FSDP_THRESHOLD
    d = "data" if (fsdp and "data" in _names(mesh)) else None
    return [
        # embeddings / heads
        (r"(embed|lm_head)/table$", ("model", d)),
        (r"frame_proj/w$", (None, "model")),
        # attention projections
        (r"attn/wq$", (d, "model")),
        (r"attn/wk$", (d, "model")),
        (r"attn/wv$", (d, "model")),
        (r"attn/wo$", ("model", d)),
        (r"attn/b[qkv]$", ("model",)),
        # MLA
        (r"attn/wdq$", (d, None)),
        (r"attn/wuq$", (None, "model")),
        (r"attn/wdkv$", (d, None)),
        (r"attn/wukv$", (None, "model")),
        (r"attn/wkr$", (d, None)),
        # cross-attn image projections
        (r"kv_proj_[kv]$", (None, "model")),
        # MoE routed experts: expert dim over model (EP). Mixtral's E=8 < 16
        # fails the divisibility guard on 'model' and falls through to
        # TP-within-expert via the d_ff dim (make_param_specs).
        (r"experts/w_gate$", ("model", d, None)),
        (r"experts/w_up$", ("model", d, None)),
        (r"experts/w_down$", ("model", None, d)),
        (r"router_w$", (None, None)),
        # dense MLPs (swiglu / gelu) incl. MoE shared expert
        (r"(ffn|shared)/w_gate$", (d, "model")),
        (r"(ffn|shared)/w_up$", (d, "model")),
        (r"(ffn|shared)/w_down$", ("model", d)),
        (r"ffn/b_up$", ("model",)),
        # Mamba2
        (r"mixer/in_proj$", (d, "model")),
        (r"mixer/out_proj$", ("model", d)),
        (r"mixer/conv_w$", (None, "model")),
        (r"mixer/conv_b$", ("model",)),
        # RWKV6
        (r"time_mix/w[rkvg]$", (d, "model")),
        (r"time_mix/wo$", ("model", d)),
        (r"channel_mix/wk$", (d, "model")),
        (r"channel_mix/wv$", ("model", d)),
        (r"channel_mix/wr$", (d, None)),
        # default: replicate (norms, biases, gates, LoRAs, scalars)
        (r".*", ()),
    ]


def path_str(name: str) -> str:
    """The reference's "/"-joined leaf path of a port parameter name
    (``layers.3.attn.wq`` -> ``segments/0/attn/wq``)."""
    return layout.jax_path(name)[0].replace(".", "/")


def _shapes(tree) -> dict:
    """``{name: shape}`` of a parameter tree: an ``nn.Module`` (on any
    device, ``meta`` included) or a mapping of name to a tensor, to
    anything with a ``shape``, or to a shape."""
    items = (tree.named_parameters() if isinstance(tree, nn.Module)
             else tree.items())
    return {n: tuple(getattr(t, "shape", t)) for n, t in items}


def make_param_specs(cfg, params_shape, mesh, fsdp: bool | None = None,
                     strategy: str = "tp") -> dict:
    """``{port parameter name: spec}`` for ``params_shape`` (an ``LM``, on
    the meta device too, or a mapping of name to shape-bearing leaves).

    strategy='tp' -- tensor/expert parallelism over 'model' (+FSDP for
                     huge archs): the framework default.
    strategy='dp' -- replicate params; batch shards over EVERY mesh axis
                     and the optimizer state is ZeRO-1 sharded over the
                     whole mesh.
    """
    shapes = _shapes(params_shape)
    if strategy == "dp":
        return {n: (None,) * len(s) for n, s in shapes.items()}
    if strategy != "tp":
        raise ValueError(f"unknown sharding strategy {strategy!r}: valid "
                         "strategies are tp, dp")
    rules = param_rules(cfg, mesh, fsdp)

    def assign(name, shape):
        ps = path_str(name)
        for pat, spec in rules:
            if re.search(pat, ps):
                # Mixtral fallback: EP spec replicated by the guard on E=8
                # => TP-within-expert on d_ff instead.
                g = _guard(mesh, spec, shape)
                if (re.search(r"experts/w_(gate|up)$", ps)
                        and g[len(shape) - 3] is None):
                    g = _guard(mesh, (None, None, "model"), shape)
                if (re.search(r"experts/w_down$", ps)
                        and g[len(shape) - 3] is None):
                    g = _guard(mesh, (None, "model", None), shape)
                return g
        return (None,) * len(shape)

    return {n: assign(n, s) for n, s in shapes.items()}


def make_opt_specs(param_specs: dict, *, mesh=None, params_shape=None,
                   zero1: bool = False) -> dict:
    """Optimizer state mirrors params; step counter replicated:
    ``{"step": (), "moments": {name: {"m": spec, "v": spec}}}``.

    ``zero1=True``: moments additionally shard their largest divisible dim
    over the WHOLE mesh (ZeRO-1) -- used with strategy='dp' where params
    are replicated but 8 bytes/param of moments must not be. The dim is
    chosen on the JAX package's stacked leaf, as the reference chooses
    it; a leaf whose choice falls on a stacked layer axis, which one
    tensor a layer cannot shard, keeps its parameter spec.
    """
    if not zero1:
        return {"step": (),
                "moments": {n: {"m": s, "v": s}
                            for n, s in param_specs.items()}}
    if mesh is None or params_shape is None:
        raise ValueError("make_opt_specs(zero1=True) needs mesh and "
                         "params_shape")
    all_axes = _entry(_names(mesh))
    world = mesh.size()
    shapes = _shapes(params_shape)
    moments = {}
    for path, names in layout.jax_leaves(shapes).items():
        stack = layout.stack_shape(names) if layout.stacked(names) else ()
        dims = [*stack, *shapes[names[0]]]
        order = sorted(range(len(dims)), key=lambda i: -dims[i])
        for i in order:
            if dims[i] % world == 0:
                break
        else:
            i = None
        for n in names:
            spec = param_specs[n]
            if i is not None and i >= len(stack):
                spec = [None] * len(shapes[n])
                spec[i - len(stack)] = all_axes
                spec = tuple(spec)
            moments[n] = {"m": spec, "v": spec}
    return {"step": (), "moments": moments}


def batch_specs(cfg, mesh, batch_shape: dict, strategy: str = "tp") -> dict:
    """Input batch: shard the leading batch dim over dp (guarded); under
    strategy='dp' the batch shards over every mesh axis."""
    del cfg
    dp = _entry(_names(mesh) if strategy == "dp" else dp_axes(mesh))
    out = {}
    for name, leaf in batch_shape.items():
        shape = tuple(leaf.shape)
        spec = [None] * len(shape)
        if shape and shape[0] % _axis_size(mesh, dp) == 0:
            spec[0] = dp
        out[name] = tuple(spec)
    return out


def _cache_spec(name: str, shape, dp, dp_n: int, tp_n: int) -> tuple:
    spec = [None] * len(shape)
    if name in ("k", "v"):               # (..., B, S, Hk, Hd)
        b_ax = len(shape) - 4
        if shape[b_ax] % dp_n == 0:
            spec[b_ax] = dp
        if shape[-2] % tp_n == 0:
            spec[-2] = "model"
        elif shape[-3] % tp_n == 0:
            spec[-3] = "model"           # sequence-parallel cache
    elif name in ("c", "kpe"):           # MLA latent: (..., B, S, D)
        b_ax = len(shape) - 3
        if shape[b_ax] % dp_n == 0:
            spec[b_ax] = dp
        if shape[-2] % tp_n == 0:
            spec[-2] = "model"           # sequence-parallel latent cache
    elif name in ("ssm", "wkv"):         # (..., B, H, N, P) / (..., B, H, D, D)
        b_ax = len(shape) - 4
        if shape[b_ax] % dp_n == 0:
            spec[b_ax] = dp
        if shape[-3] % tp_n == 0:
            spec[-3] = "model"
    elif name == "conv":                 # (..., B, W-1, C)
        b_ax = len(shape) - 3
        if shape[b_ax] % dp_n == 0:
            spec[b_ax] = dp
        if shape[-1] % tp_n == 0:
            spec[-1] = "model"
    elif name in ("tm_prev", "cm_prev"):  # (..., B, 1, d)
        b_ax = len(shape) - 3
        if shape[b_ax] % dp_n == 0:
            spec[b_ax] = dp
    return tuple(spec)


def cache_specs(cfg, mesh, cache_shape: list) -> list:
    """KV caches: batch over dp; heads over model if divisible else
    sequence over model (SP); SSM and WKV states: heads over model.
    ``cache_shape`` is ``model.init_cache``'s list of per-layer dicts
    (tensors or anything with a ``shape``); the result has its
    structure."""
    del cfg
    dp = _entry(dp_axes(mesh))
    dp_n = _axis_size(mesh, dp)
    tp_n = _axis_size(mesh, "model")
    return [{name: _cache_spec(name, tuple(leaf.shape), dp, dp_n, tp_n)
             for name, leaf in entry.items()} for entry in cache_shape]


# ---------------------------------------------------------------------------
# Specs on a DeviceMesh: placements, distribution, constraints
# ---------------------------------------------------------------------------

def _is_spec(x) -> bool:
    return isinstance(x, tuple)


def placements(mesh, spec: tuple) -> list:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on each
    mesh dim that spec entry d names, ``Replicate()`` on the others. A
    tuple entry shards one tensor dim over several mesh dims, which must
    be named in mesh order."""
    from torch.distributed.tensor import Replicate, Shard
    names = _names(mesh)
    out = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        idx = [names.index(a) if a in names else -1 for a in axes]
        if -1 in idx:
            raise ValueError(f"spec {spec} names {axes}, mesh has {names}")
        if idx != sorted(idx):
            raise ValueError(f"spec entry {axes} is not in mesh order "
                             f"{names}")
        for i in idx:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"spec {spec} uses mesh dim {names[i]!r} "
                                 "twice")
            out[i] = Shard(d)
    return out


def distribute(t: torch.Tensor, mesh, spec: tuple):
    """``t`` as a DTensor placed by ``spec``: a plain tensor (the same
    full tensor on every rank) keeps each rank's own shard, with no
    communication; a DTensor is redistributed."""
    from torch.distributed.tensor import distribute_tensor
    if is_dtensor(t):
        return t.detach().redistribute(mesh, placements(mesh, spec))
    return distribute_tensor(t.detach(), mesh, placements(mesh, spec),
                             src_data_rank=None)


def local_part(full: torch.Tensor, mesh, places) -> torch.Tensor:
    """This rank's shard of ``full`` under ``places`` (the same chunks
    ``distribute_tensor`` keeps; every sharded dim divides its mesh dims),
    wherever ``full`` lies: a view, no communication."""
    from torch.distributed.tensor import Shard
    coord = mesh.get_coordinate()
    out = full
    for i, p in enumerate(places):
        if isinstance(p, Shard):
            out = out.chunk(mesh.size(i), dim=p.dim)[coord[i]]
    return out


def _distribute_module(module: nn.Module, mesh, specs: dict) -> None:
    for name, p in list(module.named_parameters()):
        owner = module.get_submodule(name.rpartition(".")[0])
        leaf = name.rpartition(".")[2]
        setattr(owner, leaf, nn.Parameter(distribute(p, mesh, specs[name]),
                                          requires_grad=p.requires_grad))


def named(mesh, spec_tree, tree=None):
    """Placements of every spec in ``spec_tree`` (the reference's
    ``NamedSharding`` tree): a spec, or mappings and lists nesting specs.

    With ``tree`` (the same structure holding tensors; an ``nn.Module``
    stands for the mapping of its parameter names), distributes each of
    its leaves onto ``mesh`` by its spec instead and returns the tree:
    a module's parameters are replaced in place by DTensor parameters
    (``requires_grad`` kept), a mapping's or list's leaves are replaced
    in it; entries the spec tree does not name stay as they are."""
    if tree is None:
        if _is_spec(spec_tree):
            return placements(mesh, spec_tree)
        if isinstance(spec_tree, Mapping):
            return {k: named(mesh, v) for k, v in spec_tree.items()}
        return [named(mesh, v) for v in spec_tree]
    if isinstance(tree, nn.Module):
        _distribute_module(tree, mesh, spec_tree)
        return tree
    if isinstance(tree, torch.Tensor):
        return distribute(tree, mesh, spec_tree)
    keys = (spec_tree.keys() if isinstance(spec_tree, Mapping)
            else range(len(spec_tree)))
    for k in keys:
        tree[k] = named(mesh, spec_tree[k], tree[k])
    return tree


def _filtered(mesh, spec, shape) -> tuple:
    """``spec`` padded to ``shape``, without axis names ``mesh`` lacks
    (e.g. 'pod' on a single pod) and dims that don't divide their axis."""
    names = set(_names(mesh))

    def filt(entry, dim):
        if entry is None:
            return None
        if isinstance(entry, tuple):
            kept = tuple(a for a in entry if a in names)
            entry = kept if kept else None
        elif entry not in names:
            entry = None
        if entry is not None and dim % _axis_size(mesh, entry) != 0:
            entry = None
        return entry

    full = list(spec) + [None] * (len(shape) - len(spec))
    return tuple(filt(s, d) for s, d in zip(full, shape))


def maybe_wsc(x, *spec):
    """The reference's ``with_sharding_constraint`` that degrades to the
    identity off a mesh: a DTensor is redistributed to ``spec`` (filtered
    to its mesh's axes and to dims that divide them) on its own mesh; a
    plain tensor comes back as it is."""
    if not is_dtensor(x):
        return x
    mesh = x.device_mesh
    want = placements(mesh, _filtered(mesh, spec, x.shape))
    return x if list(x.placements) == want else x.redistribute(mesh, want)


def maybe_wsc_spec(x, spec):
    """:func:`maybe_wsc` with an explicit spec tuple."""
    return maybe_wsc(x, *tuple(spec))


def replicate_dim(x, dim: int):
    """``x`` whole along tensor dim ``dim``: a DTensor sharded on it, or
    holding a pending sum (``Partial``), is redistributed to ``Replicate``
    on those mesh dims, its other placements kept; a plain tensor comes
    back as it is. What a reduction over ``dim`` (a log-sum-exp, a
    gather) needs."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Partial, Replicate, Shard
    dim %= x.ndim
    want = [Replicate() if isinstance(p, Partial)
            or (isinstance(p, Shard) and p.dim == dim) else p
            for p in x.placements]
    return x if want == list(x.placements) else x.redistribute(
        x.device_mesh, want)


def whole_if_uneven(x, dim: int, n: int):
    """``x`` gathered on tensor dim ``dim`` (:func:`replicate_dim`) where
    the mesh dims that shard it do not divide ``n``, the count it is to be
    unflattened into (two kv heads over a "model" of 8; 32 sequences'
    rows over 64 dp ranks; rows over 32 ranks into 4 microbatches); as it
    is otherwise, and off a mesh. DTensor cannot unflatten an uneven
    split, where GSPMD reshards it."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Shard
    dim %= x.ndim
    shards = math.prod(x.device_mesh.size(i)
                       for i, p in enumerate(x.placements)
                       if isinstance(p, Shard) and p.dim == dim)
    return x if n % shards == 0 else replicate_dim(x, dim)


def on_mesh(tree) -> bool:
    """Whether ``tree`` (a module or a tensor) holds DTensor parameters."""
    first = next(iter(tree.parameters()), None) if isinstance(
        tree, nn.Module) else tree
    return is_dtensor(first)


_REPLICATION_DEPTH = [0]


@contextlib.contextmanager
def replicate_constants(tree):
    """While DTensors run through the model, treat the plain tensors made
    beside them (positions, RoPE tables, masks, loss sums) as replicated
    (``implicit_replication``). A no-op unless ``tree`` holds DTensor
    parameters, and re-entrant: only the outermost scope switches it."""
    if not on_mesh(tree) or _REPLICATION_DEPTH[0]:
        yield
        return
    from torch.distributed.tensor.experimental import implicit_replication
    _REPLICATION_DEPTH[0] += 1
    try:
        with implicit_replication():
            yield
    finally:
        _REPLICATION_DEPTH[0] -= 1
