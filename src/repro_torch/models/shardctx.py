"""Partition specs, their DTensor placements, and the activation-sharding
rules, injected contextually.

Port of the JAX package's ``models/shardctx.py`` and of the
``PartitionSpec`` trees its model modules build. A spec `P` is a tuple
with one entry per tensor dim: None (not sharded), a mesh axis name, or a
tuple of axis names (one tensor dim split over several mesh axes, major to
minor), as in JAX. `placements(spec, mesh)` turns it into the DTensor
placements on a ``DeviceMesh`` with JAX's axis names: ``Shard(d)`` on every
mesh dim that tensor dim d names, ``Replicate()`` on the others.

The baseline dry-run gives placements to parameters and inputs only and
lets DTensor's sharding propagation choose each op's output layout, where
JAX lets GSPMD choose. The optimized configuration installs explicit rules
(Megatron-style: residual stream data-sharded and replicated over `model`;
logits vocab-sharded), applied by the ``constrain()`` calls inside the
model: a DTensor is redistributed to its rule's placements (JAX's
``with_sharding_constraint``). Rules default to None, and a plain tensor
passes unchanged, so every single-device run is unaffected.

The model modules are written in plain tensor ops. A sharded program runs
them under `dtensor_ops()`: DTensor's ``implicit_replication`` (the plain
tensors a step makes, such as positions, masks and scalars, count as
replicated) and a function mode that routes the few ops whose DTensor
rules would gather a shard whole or fail to the shard-wise forms below:
the embedding lookup (``F.embedding``) and the loss's ``logsumexp`` and
label ``gather`` on vocab-sharded tensors, the vocab projection (a matmul
by a column-sharded weight), reshapes across unevenly sharded heads, and
cache writes into a sharded length. The attention core is the one model
function that knows of shards (`shard_local`): it runs on each rank's
local shards, as a shard_map'ed attention would.
"""
from __future__ import annotations

import contextlib
import contextvars
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor._utils import \
    compute_local_shape_and_global_offset
from torch.distributed.tensor.experimental import implicit_replication


class P(tuple):
    """A partition spec: one entry per leading tensor dim, each None, a
    mesh axis name, or a tuple of axis names; missing trailing entries are
    None. Equal, as a tuple, to the JAX ``PartitionSpec`` it ports."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return "P" + (tuple.__repr__(self) if len(self) != 1
                      else f"({self[0]!r})")


def is_spec(x) -> bool:
    return isinstance(x, P)


def _names(entry) -> tuple:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def placements(spec: P, mesh) -> tuple:
    """The DTensor placements of `spec` on `mesh` (a ``DeviceMesh`` with
    dim names): Shard(d) on each mesh dim that entry d names, Replicate()
    on every other. An entry naming several axes must name them in the
    mesh's order (DTensor splits a dim over mesh dims major to minor)."""
    names = mesh.mesh_dim_names
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        axes = _names(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: axes {axes} are not in the "
                             f"mesh's order {names}")
        for i in idx:
            if out[i] != Replicate():
                raise ValueError(f"spec {spec}: mesh axis {names[i]!r} "
                                 "named twice")
            out[i] = Shard(d)
    return tuple(out)


class NamedSharding(NamedTuple):
    """A spec on a mesh: what an activation rule names (JAX's
    ``NamedSharding``)."""

    mesh: object
    spec: P

    @property
    def placements(self) -> tuple:
        return placements(self.spec, self.mesh)


_RULES: contextvars.ContextVar[dict | None] = contextvars.ContextVar(
    "shard_rules", default=None)


@contextlib.contextmanager
def sharding_rules(rules: dict | None):
    """Install activation-sharding rules (name -> NamedSharding, or None
    for no constraint) for the enclosed calls."""
    tok = _RULES.set(rules)
    try:
        yield
    finally:
        _RULES.reset(tok)


def constrain(x, name: str):
    """The activation `x` under the rule `name`: a DTensor redistributed to
    the rule's placements; `x` itself when no rule names it or `x` is a
    plain tensor."""
    rules = _RULES.get()
    if rules is None or rules.get(name) is None:
        return x
    if not isinstance(x, DTensor):
        return x
    sh = rules[name]
    return x.redistribute(sh.mesh, sh.placements)


def _replicated(x, mesh):
    """A plain tensor as a DTensor replicated on `mesh`; a DTensor as it is."""
    if isinstance(x, DTensor):
        return x
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def from_local(local, mesh, pl, shape):
    """The DTensor of global `shape` (contiguous strides) laid out by the
    placements `pl`, whose shard on this rank is `local`."""
    shape = torch.Size(shape)
    return DTensor.from_local(local, mesh, pl, run_check=False, shape=shape,
                              stride=torch.empty(shape, device="meta").stride())


def _box(x):
    """(local shape, global offset) of this rank's shard of DTensor `x`."""
    return compute_local_shape_and_global_offset(x.shape, x.device_mesh,
                                                 x.placements)


def sharded_on(x, dim: int) -> bool:
    """Whether `x` is a DTensor sharded on tensor dim `dim`."""
    return isinstance(x, DTensor) and any(
        isinstance(p, Shard) and p.dim == dim % x.ndim for p in x.placements)


def reduce_partial(x):
    """A DTensor's pending partial sums reduced (Replicate on those mesh
    dims); a plain tensor unchanged."""
    if not isinstance(x, DTensor) or not any(isinstance(p, Partial)
                                             for p in x.placements):
        return x
    return x.redistribute(x.device_mesh, [
        Replicate() if isinstance(p, Partial) else p for p in x.placements])


def column_parallel(x, w):
    """x @ w for DTensors, where `w` has its columns sharded (the vocab of
    the head, or of a tied table's transpose): x is first gathered on those
    mesh dims, so the product comes out sharded on the columns, as GSPMD
    propagates a column-sharded weight (DTensor's own choice may gather
    the weight instead, and hold every column of the f32 logits). Where x
    is already whole on those dims (every other column-parallel weight),
    nothing moves."""
    cols = w.ndim - 1
    pl = [Replicate() if isinstance(wp, Shard) and wp.dim == cols
          else xp for xp, wp in zip(x.placements, w.placements)]
    if list(pl) != list(x.placements):
        x = x.redistribute(x.device_mesh, pl)
    return x @ w


def take_rows(table, idx):
    """``F.embedding(idx, table)`` for a DTensor `table` (idx (...) ->
    (..., D)), also where it is sharded on its rows (the vocab-sharded
    embedding): each rank looks up the indices that fall in its own rows
    and takes 0 for the others, and the partial sums over the mesh dims
    that shard the rows are then reduced (Megatron's vocab-parallel
    embedding), where DTensor's own lookup would gather the table or leave
    a masked partial sum that its backward cannot take. Differentiable in
    `table`."""
    mesh, out_dim = table.device_mesh, idx.ndim
    idx = _replicated(idx, mesh)
    idx_pl, out_pl = [], []
    for tp, ip in zip(table.placements, idx.placements):
        if isinstance(tp, Shard):       # rows: partial sums; columns: shard
            idx_pl.append(Replicate())
            out_pl.append(Partial() if tp.dim == 0 else Shard(out_dim))
        elif isinstance(tp, Partial):
            idx_pl.append(Replicate())
            out_pl.append(tp)
        else:
            keep = isinstance(ip, Shard)
            idx_pl.append(ip if keep else Replicate())
            out_pl.append(ip if keep else Replicate())
    shape = tuple(idx.shape) + (table.shape[1],)
    idx = idx.redistribute(mesh, idx_pl).to_local()
    size, offset = _box(table)
    rel = idx.long() - offset[0]
    inside = (rel >= 0) & (rel < size[0])
    # a rank holding all of the table's rows (Replicate) but only some of
    # the indices (Shard) gives a partial sum of the table's gradient
    grad_pl = [Partial() if not isinstance(tp, (Shard, Partial))
               and isinstance(ip, Shard) else tp
               for tp, ip in zip(table.placements, idx_pl)]
    val = F.embedding(rel.clamp(0, max(size[0] - 1, 0)),
                      table.to_local(grad_placements=grad_pl))
    val = torch.where(inside[..., None], val, torch.zeros(
        (), dtype=val.dtype, device=val.device))
    return reduce_partial(from_local(val, mesh, out_pl, shape))


def logsumexp_last(x):
    """``torch.logsumexp(x, dim=-1)`` for a DTensor sharded on its last dim
    (the vocab-sharded logits): the max and the sum of exponents are
    reduced across the shards (DTensor's own logsumexp gathers the last
    dim whole)."""
    m = reduce_partial(x.detach().amax(dim=-1, keepdim=True))
    return m[..., 0] + torch.log(reduce_partial(torch.exp(x - m).sum(dim=-1)))


def gather_last(x, index):
    """``torch.gather(x, -1, index)`` (index (..., n)), where `x` is a
    DTensor sharded on its last dim (the vocab-sharded logits): each rank
    gathers the indices that fall in its own shard and takes 0 for the
    others, and the result is a partial sum over the mesh dims that shard
    the last dim, so no shard is gathered whole. Differentiable in `x`."""
    last, mesh = x.ndim - 1, x.device_mesh
    on_last = [isinstance(p, Shard) and p.dim == last for p in x.placements]
    # the index laid out as x is on its other dims, whole along the last
    # (and where x holds partial sums: gathering is linear)
    idx_pl = [p if isinstance(p, Shard) and not o else Replicate()
              for p, o in zip(x.placements, on_last)]
    idx = _replicated(index, mesh).redistribute(mesh, idx_pl).to_local()
    size, offset = _box(x)
    rel = idx.long() - offset[last]
    inside = (rel >= 0) & (rel < size[last])
    val = torch.gather(x.to_local(), -1, rel.clamp(0, max(size[last] - 1, 0)))
    val = torch.where(inside, val, torch.zeros((), dtype=val.dtype,
                                               device=val.device))
    out_pl = [Partial() if o else p for p, o in zip(x.placements, on_last)]
    return from_local(val, mesh, out_pl, index.shape)


def _reshape_dtensor(x, shape):
    try:
        return x.reshape(*shape)
    except RuntimeError:
        new = torch.empty(x.shape, device="meta").reshape(*shape).shape
        first = next((i for i, (a, b) in enumerate(zip(x.shape, new))
                      if a != b), min(x.ndim, len(new)))
        pl = [Replicate() if isinstance(p, Shard) and p.dim >= first else p
              for p in x.placements]
        return x.redistribute(x.device_mesh, pl).reshape(*shape)


class _Reshape(torch.autograd.Function):
    """A DTensor reshape whose backward takes the same care (autograd's own
    view backward would reshape the gradient as it comes)."""

    @staticmethod
    def forward(ctx, x, shape):
        ctx.shape = x.shape
        return _reshape_dtensor(x, shape)

    @staticmethod
    def backward(ctx, grad):
        return _reshape_dtensor(grad, ctx.shape), None


def reshape(x, *shape):
    """``x.reshape(*shape)`` for a DTensor, also where DTensor cannot carry
    its sharding through the reshape (a sharded dim split into parts whose
    leading one the shard count does not divide, as 8 kv heads over a
    16-way 'model' axis): its sharded dims from the first one the reshape
    changes on are first gathered (Replicate), where GSPMD would re-tile;
    the gradient is reshaped back the same way."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _Reshape.apply(x, shape)
    return _reshape_dtensor(x, shape)


def heads_local(fn, q, k, v, *args, **kwargs):
    """fn(q, k, v, *args) for an attention core over (B, S, H, d) queries
    and (B, T, K, d) keys and values, run on each rank's local shards when
    they are DTensors, as a shard_map'ed attention would: the core is then
    plain tensor code (no DTensor op per score block). Batch stays sharded
    where it is. Query heads stay sharded on one mesh dim where that dim
    divides H; there keys and values are sharded alike where it divides K
    too, and else (fewer kv heads than shards: 8 kv heads on a 16-way
    'model' axis) gathered whole and cut to the kv heads this rank's query
    heads read (their gradient a partial sum over that dim). Every other
    dim is gathered first. The result comes back laid out as the queries."""
    mesh = q.device_mesh
    h, kh = q.shape[2], k.shape[2]
    qpl, kpl, kgrad, pick = [], [], [], None
    for i, p in enumerate(q.placements):
        n = mesh.size(i)
        qp = kp = kg = Replicate()
        if isinstance(p, Shard) and p.dim == 0:
            qp = kp = kg = p
        elif (isinstance(p, Shard) and p.dim == 2 and h % n == 0
              and Shard(2) not in qpl and (kh % n == 0 or n % kh == 0)):
            qp = p
            if kh % n == 0:
                kp = kg = p
            else:           # n // kh ranks share each kv head
                kg, pick = Partial(), (i, n // kh)
        qpl.append(qp)
        kpl.append(kp)
        kgrad.append(kg)
    ql = q.redistribute(mesh, qpl).to_local()
    kl, vl = (t.redistribute(mesh, kpl).to_local(grad_placements=kgrad)
              for t in (k, v))
    if pick is not None:
        j = mesh.get_local_rank(pick[0]) // pick[1]
        kl, vl = kl[:, :, j:j + 1], vl[:, :, j:j + 1]
    out = fn(ql, kl, vl, *args, **kwargs).contiguous()
    return from_local(out, mesh, qpl, q.shape[:3] + (v.shape[3],))


def shard_local(fn):
    """An attention core fn(q, k, v, ...) over (B, S, H, d) queries and
    (B, T, K, d) keys and values, as written for plain tensors; on DTensors
    it runs on each rank's local shards (`heads_local`), but where the
    keys are sharded on their length (a cache sharded on it) it runs as
    DTensor ops, so the scores stay sharded on it rather than the cache
    being gathered whole."""
    @functools.wraps(fn)
    def run(q, k, v, *args, **kwargs):
        if type(q) is torch.Tensor or sharded_on(k, 1):
            return fn(q, k, v, *args, **kwargs)
        return heads_local(fn, q, k, v, *args, **kwargs)
    return run


def write_rows(dst, key, src) -> bool:
    """dst[:, a:b] = src, in place, for a DTensor `dst` sharded on dim 1 (a
    cache sharded on its length): `src` is laid out as `dst` with dim 1
    whole, and each rank writes the rows that fall in its own shard.
    (DTensor's own slice assignment on a sharded dim writes into a gathered
    copy.) False, with nothing written, for any other key."""
    if not (isinstance(key, tuple) and len(key) == 2
            and key[0] == slice(None) and isinstance(key[1], slice)
            and key[1].step is None):
        return False
    start, stop, _ = key[1].indices(dst.shape[1])
    mesh = dst.device_mesh
    pl = [Replicate() if isinstance(p, Shard) and p.dim == 1 else p
          for p in dst.placements]
    src = _replicated(src, mesh).redistribute(mesh, pl).to_local()
    size, offset = _box(dst)
    lo, hi = max(start, offset[1]), min(stop, offset[1] + size[1])
    if lo < hi:
        dst.to_local()[:, lo - offset[1]:hi - offset[1]] = \
            src[:, lo - start:hi - start].to(dst.dtype)
    return True


def _route(func, args, kwargs, vocab):
    """The shard-wise form of func(*args, **kwargs) on DTensors, or
    NotImplemented where DTensor's own rule serves. `vocab`: the columns
    of the vocab projection's weight."""
    if func in (torch.Tensor.reshape, torch.reshape):
        x, shape = args[0], args[1:]
        if isinstance(x, DTensor):
            return reshape(x, *(shape[0] if len(shape) == 1
                                and not isinstance(shape[0], int)
                                else shape))
    elif func in (torch.Tensor.__matmul__, torch.Tensor.matmul,
                  torch.matmul):
        x, w = args
        if (isinstance(x, DTensor) and isinstance(w, DTensor)
                and w.ndim == 2 and w.shape[1] == vocab
                and sharded_on(w, 1)):
            return column_parallel(x, w)
    elif func is F.embedding:
        idx, table = args[:2]
        if (isinstance(table, DTensor) and len(args) == 2
                and kwargs.get("padding_idx") is None
                and kwargs.get("max_norm") is None):
            return take_rows(table, idx)
    elif func in (torch.logsumexp, torch.Tensor.logsumexp):
        x = args[0]
        dim = args[1] if len(args) > 1 else kwargs.get("dim")
        if (isinstance(dim, int) and dim % x.ndim == x.ndim - 1
                and sharded_on(x, -1) and not kwargs.get("keepdim")):
            return logsumexp_last(x)
    elif func in (torch.gather, torch.Tensor.gather):
        x, dim, index = args[:3]
        if (dim % x.ndim == x.ndim - 1 and sharded_on(x, -1)
                and len(args) == 3 and not kwargs):
            return gather_last(x, index)
    elif func is torch.Tensor.__setitem__:
        dst, key, src = args
        if sharded_on(dst, 1) and write_rows(dst, key, src):
            return None
    return NotImplemented


class _ShardWiseOps(TorchFunctionMode):
    """Routes the ops of `_route` to their shard-wise forms where their
    arguments are DTensors; every other call runs as it is. (The mode is
    off while its handler runs, so the forms call the plain ops.)"""

    def __init__(self, vocab: int | None):
        super().__init__()
        self.vocab = vocab

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = _route(func, args, kwargs, self.vocab)
        if out is NotImplemented:
            return func(*args, **kwargs)
        return out


_ROUTED: contextvars.ContextVar[tuple | None] = contextvars.ContextVar(
    "shard_wise_ops", default=None)


@contextlib.contextmanager
def dtensor_ops(vocab: int | None = None):
    """Run the model's plain-tensor code as a sharded program over the
    DTensors it is given: DTensor's ``implicit_replication`` and the
    shard-wise routes of `_route`; `vocab` names the vocab projection (a
    matmul by a weight of `vocab` columns: the head, or the tied table's
    transpose)."""
    tok = _ROUTED.set((vocab,))
    try:
        with implicit_replication(), _ShardWiseOps(vocab):
            yield
    finally:
        _ROUTED.reset(tok)


def recompute_context():
    """The ``context_fn`` of the model's ``torch.utils.checkpoint``: the
    layers it recomputes in the backward run under the rules and the
    routes that their forward ran under. (The backward may run on another
    thread, which does not see the context variables, and is entered
    through a torch function, which leaves the routes' mode off.)"""
    rules, routed = _RULES.get(), _ROUTED.get()

    @contextlib.contextmanager
    def again():
        with sharding_rules(rules), (_ShardWiseOps(*routed) if routed
                                     else contextlib.nullcontext()):
            yield
    return contextlib.nullcontext(), again()
