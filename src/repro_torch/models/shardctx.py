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
cache writes into a sharded length. Three more forms take ops that torch
2.11's DTensor refuses on the dry-run's path: MoE's indexing by token
(`take`: an index split over several mesh axes, and the backward of an
index that adds dims), the SSD's ``cumsum`` under autograd
(`cumsum_local`: its backward flips the gradient, for which 2.11 has no
rule), and a matmul or a two-operand einsum whose flatten of dims would
cross a sharded dim (`local_einsum`: MLA's latent cache, sharded on its
length, in decode). Two take MoE's layouts where DTensor's own rules
would gather a shard whole: `take` reads a dim that x shards as partial
sums (the combine's expert outputs, sharded on the expert dim), and an
expert product whose expert weights are sharded where the dispatched
tokens are whole goes to `local_einsum`, which cuts the tokens per rank.
The attention core is the one model function that knows of shards
(`shard_local`): it runs on each rank's local shards, as a shard_map'ed
attention would.
"""
from __future__ import annotations

import contextlib
import contextvars
import functools
import itertools
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch._prims_common import infer_size
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


def _contiguous_strides(shape) -> tuple:
    strides, n = [], 1
    for size in reversed(shape):
        strides.append(n)
        n *= max(size, 1)
    return tuple(reversed(strides))


def from_local(local, mesh, pl, shape):
    """The DTensor of global `shape` (contiguous strides) laid out by the
    placements `pl`, whose shard on this rank is `local`."""
    shape = torch.Size(shape)
    return DTensor.from_local(local, mesh, pl, run_check=False, shape=shape,
                              stride=_contiguous_strides(shape))


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
        new = infer_size(shape, x.numel())
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


def _flatten_refused(x, groups) -> bool:
    """Whether reshaping DTensor `x` with each group of its dims (in that
    order) merged into one is a view (every group's strides merge) that
    merges a sharded dim behind another of size > 1: some torch releases
    refuse such a view rather than gather (a reshape they cannot view,
    they copy, and gather)."""
    refused = False
    for dims in groups:
        dims = [d for d in dims if x.shape[d] != 1]
        if any(x.stride(a) != x.stride(b) * x.shape[b]
               for a, b in zip(dims, dims[1:])):
            return False
        refused |= any(sharded_on(x, d) for d in dims[1:])
    return refused


def _einsum_groups(equation: str, shapes) -> list | None:
    """For a two-operand einsum, each operand's dims in the groups that
    torch's einsum flattens before its batched product (of the letters of
    size > 1: those in both operands and the output, those in both and
    summed, those of one operand in the output), each group in torch's
    label order (the output's letters, then the summed ones sorted); None
    for an equation outside that form (``...``, a repeated letter, a
    letter broadcast from size 1)."""
    ins, _, out = equation.replace(" ", "").partition("->")
    ins = ins.split(",")
    if (len(ins) != 2 or "." in equation or not out
            or any(len(set(s)) != len(s) for s in ins)):
        return None
    order = list(out) + sorted(set("".join(ins)) - set(out))
    size = [dict(zip(s, sh)) for s, sh in zip(ins, shapes)]
    if any(size[0][c] != size[1][c] for c in set(ins[0]) & set(ins[1])):
        return None
    nontrivial = [{c for c, n in sz.items() if n != 1} for sz in size]
    both = nontrivial[0] & nontrivial[1]
    groups = [[c for c in order if c in both and c in out],
              [c for c in order if c in both and c not in out],
              [c for c in order if c in nontrivial[0] - both and c in out],
              [c for c in order if c in nontrivial[1] - both and c in out]]
    return [[[s.index(c) for c in g if c in s] for g in groups] for s in ins]


def _batch_split(equation: str, operands) -> bool:
    """Whether, on some mesh dim, one operand of a two-operand einsum is
    sharded on its leading letter, a batch letter (one in both operands
    and the output), that the other holds whole there (replicated, or
    sharded on another letter): MoE's expert products, whose expert
    weights (experts, ·, ·) are sharded on 'model', where the dispatched
    tokens are not sharded on the expert dim. DTensor's own einsum may
    then make the product a partial sum and reduce the whole output,
    where `local_einsum` slices the whole operand and keeps the letter
    sharded. A partial-sum operand is left to DTensor. The dense archs'
    einsums are left alone: the SSD's chunk products and MLA's attention
    products (their head letter, sharded in one operand and whole in the
    other, is no operand's leading letter), the attention scores."""
    ins = equation.replace(" ", "").partition("->")[0].split(",")
    out = equation.partition("->")[2].strip()
    mesh = next(o for o in operands if isinstance(o, DTensor)).device_mesh
    pls = [o.placements if isinstance(o, DTensor)
           else (Replicate(),) * mesh.ndim for o in operands]
    for i in range(mesh.ndim):
        for a, b in ((0, 1), (1, 0)):
            pa, pb = pls[a][i], pls[b][i]
            if (not isinstance(pa, Shard) or pa.dim != 0
                    or isinstance(pb, Partial)):
                continue
            c = ins[a][0]
            if c in ins[b] and c in out and not (
                    isinstance(pb, Shard) and ins[b][pb.dim] == c):
                return True
    return False


class _Cut(torch.autograd.Function):
    """DTensor `x`'s local shard under the placements `pl`, where `x` is
    whole on the mesh dims `cut` that `pl` shards: redistributed to `pl`
    on its other mesh dims, then sliced. Its gradient comes back laid out
    as `pl` on the cut dims (each rank's slice) and as `grad` on the
    others, as it is: a redistribute's backward would gather it into x's
    placements first."""

    @staticmethod
    def forward(ctx, x, pl, cut, grad):
        mesh = x.device_mesh
        mid = [p if c else q for p, q, c in zip(x.placements, pl, cut)]
        size, offset = compute_local_shape_and_global_offset(x.shape, mesh,
                                                             pl)
        _, base = compute_local_shape_and_global_offset(x.shape, mesh, mid)
        ctx.mesh, ctx.shape = mesh, x.shape
        ctx.grad = [p if c else g for p, c, g in zip(pl, cut, grad)]
        local = x.redistribute(mesh, mid).to_local()
        return local[tuple(slice(a - b, a - b + n)
                           for a, b, n in zip(offset, base, size))]

    @staticmethod
    def backward(ctx, g):
        return (from_local(g.contiguous(), ctx.mesh, ctx.grad, ctx.shape),
                None, None, None)


def _local_shard(x, pl, grad):
    """DTensor `x`'s local shard under the placements `pl`, its gradient
    laid out by `grad`. Where x is whole on a mesh dim that `pl` shards, it
    is cut per rank (`_Cut`) and its gradient comes back sharded there, as
    `pl`: the gradient of an expert product for the dispatched tokens,
    which the take that dispatched them adds per rank into a partial sum,
    where a redistribute's backward would gather it whole."""
    cut = [isinstance(p, Replicate) and isinstance(q, Shard)
           for p, q in zip(x.placements, pl)]
    if any(cut):
        return _Cut.apply(x, pl, cut, grad)
    return x.redistribute(x.device_mesh, pl).to_local(grad_placements=grad)


def local_einsum(equation: str, *operands):
    """``torch.einsum(equation, a, b)`` on each rank's shards, for DTensor
    operands (plain ones count as replicated). On each mesh dim one letter
    stays sharded, the one of the largest operand sharded there: the
    operands that hold it are sharded on it and the others gathered whole,
    and the product is sharded on it, or a partial sum where it is summed.
    Where no operand is sharded on a mesh dim and one holds partial sums,
    the product holds them (it is linear in each operand). Every other
    sharding is gathered. DTensor's own einsum flattens groups of dims for
    its batched product (and matmul its leading dims), which some torch
    releases refuse across a sharded dim (MLA's latent cache, sharded on
    its length, times an up-projection; a head-sharded query against it).
    Differentiable in every operand."""
    ins, _, out = equation.replace(" ", "").partition("->")
    ins = ins.split(",")
    mesh = next(o for o in operands if isinstance(o, DTensor)).device_mesh
    ops = [_replicated(o, mesh) for o in operands]
    pls, grads, out_pl = [[] for _ in ops], [[] for _ in ops], []
    for i in range(mesh.ndim):
        held = {}
        for o, s in zip(ops, ins):
            p = o.placements[i]
            if isinstance(p, Shard):
                held[s[p.dim]] = max(held.get(s[p.dim], 0), o.numel())
        partial = [k for k, o in enumerate(ops)
                   if isinstance(o.placements[i], Partial)]
        if held:
            c = max(held, key=held.get)
            for k, s in enumerate(ins):
                pl = Shard(s.index(c)) if c in s else Replicate()
                pls[k].append(pl)
                grads[k].append(pl if c in s else Partial())
            out_pl.append(Shard(out.index(c)) if c in out else Partial())
        elif len(partial) == 1:
            for k, o in enumerate(ops):
                pls[k].append(o.placements[i] if k in partial else Replicate())
                grads[k].append(Replicate() if k in partial else Partial())
            out_pl.append(ops[partial[0]].placements[i])
        else:
            for k in range(len(ops)):
                pls[k].append(Replicate())
                grads[k].append(Replicate())
            out_pl.append(Replicate())
    local = [_local_shard(o, pl, g) for o, pl, g in zip(ops, pls, grads)]
    val = torch.einsum(equation, *local)
    size = {c: n for s, o in zip(ins, ops) for c, n in zip(s, o.shape)}
    return from_local(val, mesh, out_pl, tuple(size[c] for c in out))


def cumsum_local(x, dim: int):
    """``torch.cumsum(x, dim)`` for a DTensor `x` whole along `dim`, on each
    rank's shard (partial sums stay partial: the sum is linear). Its
    backward is autograd's on the local shard: the reversed cumulative sum
    that some torch releases refuse on a DTensor (``flip`` has no sharding
    rule there)."""
    return from_local(torch.cumsum(x.to_local(), dim), x.device_mesh,
                      x.placements, x.shape)


def _split_dims(x) -> bool:
    """Whether DTensor `x` splits one tensor dim over several mesh dims."""
    dims = [p.dim for p in x.placements if isinstance(p, Shard)]
    return len(dims) != len(set(dims))


def _local_indices(indices, mesh, pl, shape) -> tuple:
    """Index tensors (plain or DTensor) that broadcast to `shape`, each cut
    to this rank's box of a tensor of `shape` laid out by `pl` (Shard
    entries beyond `shape`'s dims ignored): sharded on dim b where it spans
    b, whole where it broadcasts along it."""
    n, out = len(shape), []
    for idx in indices:
        off = n - idx.ndim
        ipl = [Shard(p.dim - off) if isinstance(p, Shard)
               and off <= p.dim < n and idx.shape[p.dim - off] == shape[p.dim]
               else Replicate() for p in pl]
        out.append(_replicated(idx, mesh).redistribute(mesh, ipl).to_local())
    return tuple(out)


def _take_layout(x, indices):
    """The layout of ``x[i0, ..., ik]`` on each rank's shard: (x's
    placements to index, the output's placements, the output's global
    shape, the mesh dims laid out as partial sums). On each mesh dim: a
    kept dim of x keeps its sharding, and a partial sum stays one. Where x
    is sharded on an indexed dim, each rank reads only the entries whose
    index falls in its own shard and takes 0 for the others (exactly one
    rank holds each entry), with the indices whole there, and the output
    is a partial sum there; that is taken where the output's local bytes
    (the most its later reduction moves, where DTensor next needs the
    whole value: fewer where a linear op such as a sum over a dim comes
    first) and the indices gathered cost no more than gathering x there.
    Else x is gathered there, and the output is sharded as the first index
    sharded there, or whole."""
    mesh, k = x.device_mesh, len(indices)
    shape = torch.broadcast_shapes(*(i.shape for i in indices))
    out_shape = tuple(shape) + tuple(x.shape[k:])
    # the first index sharded on each mesh dim lays the output out
    by_index = [next((Shard(p.dim + len(shape) - i.ndim) for i in indices
                      if isinstance(i, DTensor)
                      for p in (i.placements[d],) if isinstance(p, Shard)),
                     None) for d in range(mesh.ndim)]
    x_pl, out_pl, masked = [], [], []
    for d, (xp, ip) in enumerate(zip(x.placements, by_index)):
        if isinstance(xp, Shard) and xp.dim >= k and ip is None:
            x_pl.append(xp)                                 # a kept dim
            out_pl.append(Shard(xp.dim - k + len(shape)))
        elif isinstance(xp, Partial) and ip is None:
            x_pl.append(xp)
            out_pl.append(xp)
        else:
            if (isinstance(xp, Shard) and xp.dim < k
                    and x.dtype is not torch.bool):
                masked.append(d)
            x_pl.append(Replicate())
            out_pl.append(ip if ip is not None else Replicate())
    # the partial-sum dims of least cost: x's bytes gathered where x is
    # gathered, the output's local bytes where it is a partial sum, and
    # the indices gathered on the partial-sum dims that shard them
    best, chosen = None, []
    for n in range(len(masked), -1, -1):
        for dims in itertools.combinations(masked, n):
            xp = [x.placements[d] if d in dims else p
                  for d, p in enumerate(x_pl)]
            op = [Partial() if d in dims else p for d, p in enumerate(out_pl)]
            cost = ((_local_bytes(x.shape, mesh, xp, x)
                     if xp != list(x.placements) else 0)
                    + (_local_bytes(out_shape, mesh, op, x) if dims else 0)
                    + sum(_local_bytes(i.shape, mesh, [
                        Replicate() if e in dims else p
                        for e, p in enumerate(i.placements)], i)
                        for i in indices if isinstance(i, DTensor)
                        and any(isinstance(i.placements[d], Shard)
                                for d in dims)))
            if best is None or cost < best:
                best, chosen = cost, list(dims)
    for d in chosen:
        x_pl[d], out_pl[d] = x.placements[d], Partial()
    return x_pl, out_pl, out_shape, chosen


def _local_bytes(shape, mesh, pl, like) -> int:
    """Bytes of this rank's shard of a tensor of `shape` and `like`'s dtype
    laid out by the placements `pl`."""
    size, _ = compute_local_shape_and_global_offset(shape, mesh, pl)
    return math.prod(size) * like.element_size()


def _masked_indices(idx, k, shape, pl, mesh):
    """Index tensors `idx` of a tensor of global `shape` laid out by `pl`,
    each made relative to this rank's box on the indexed dims `pl` shards
    (clamped into it), and the mask of the entries inside the box (None
    where no indexed dim is sharded)."""
    dims = sorted({p.dim for p in pl if isinstance(p, Shard) and p.dim < k})
    if not dims:
        return idx, None
    size, offset = compute_local_shape_and_global_offset(shape, mesh, pl)
    idx, inside = list(idx), None
    for j in dims:
        rel = idx[j].long() - offset[j]
        ok = (rel >= 0) & (rel < size[j])
        inside = ok if inside is None else inside & ok
        idx[j] = rel.clamp(0, max(size[j] - 1, 0))
    return tuple(idx), inside


def _zero_outside(val, inside, kept: int):
    """`val` (index dims, then `kept` dims) with 0 where `inside` is
    False."""
    if inside is None:
        return val
    lead = val.shape[:val.ndim - kept]
    mask = torch.broadcast_to(inside, lead).reshape(lead + (1,) * kept)
    return torch.where(mask, val, torch.zeros((), dtype=val.dtype,
                                              device=val.device))


class _Take(torch.autograd.Function):
    """``x[i0, ..., ik]`` (integer index tensors on x's leading dims) on each
    rank's shard; see `take`."""

    @staticmethod
    def forward(ctx, x, *indices):
        mesh, k = x.device_mesh, len(indices)
        x_pl, out_pl, out_shape, masked = _take_layout(x, indices)
        ctx.indices, ctx.x_shape, ctx.x_pl, ctx.masked = \
            indices, x.shape, x_pl, masked
        ctx.nb = len(out_shape) - (x.ndim - k)
        xl = x.redistribute(mesh, x_pl).to_local()
        idx = _local_indices(indices, mesh, out_pl, out_shape[:ctx.nb])
        idx, inside = _masked_indices(idx, k, x.shape, x_pl, mesh)
        if inside is not None and 0 in xl.shape[:k]:
            # this rank holds none of the indexed entries
            val = xl.new_zeros(torch.broadcast_shapes(*(i.shape for i in idx))
                               + xl.shape[k:])
        else:
            val = _zero_outside(xl[idx], inside, x.ndim - k)
        return from_local(val, mesh, out_pl, out_shape)

    @staticmethod
    def backward(ctx, grad):
        mesh, nb, k = grad.device_mesh, ctx.nb, len(ctx.indices)
        if ctx.masked:
            # the gradient whole on the partial-sum mesh dims: each rank
            # adds the entries in its own shard, so x's gradient keeps x's
            # placements there and nothing moves
            grad = grad.redistribute(mesh, [
                Replicate() if d in ctx.masked else p
                for d, p in enumerate(grad.placements)])
        # each rank adds its own slots of the gradient: a partial sum over
        # the mesh dims that shard the slots
        pl = [(Partial() if p.dim < nb else Shard(p.dim - nb + k))
              if isinstance(p, Shard) else p for p in grad.placements]
        for d in ctx.masked:
            pl[d] = ctx.x_pl[d]
        size, _ = compute_local_shape_and_global_offset(ctx.x_shape, mesh, pl)
        gl = grad.to_local()
        idx = _local_indices(ctx.indices, mesh, grad.placements,
                             grad.shape[:nb])
        idx, inside = _masked_indices(idx, k, ctx.x_shape, pl, mesh)
        out = gl.new_zeros(size)
        if inside is None or 0 not in size[:k]:
            out.index_put_(idx, _zero_outside(gl, inside, len(size) - k),
                           accumulate=True)
        return (from_local(out, mesh, pl, ctx.x_shape),) + (None,) * k


def take(x, *indices):
    """``x[i0, ..., ik]`` for a DTensor `x` and integer index tensors (plain
    or DTensor) on its leading dims, on each rank's shard: the output is
    laid out as the indices are (x gathered whole on those mesh dims); its
    kept dims keep their sharding; an indexed dim that x shards gives a
    partial sum, each rank reading the entries in its own shard, where that
    costs no more than gathering x (`_take_layout`). MoE's combine reads
    the expert outputs, sharded on the expert dim, so: the (tokens, k, d_model) partial sums it reads are about as large
    as the (experts, capacity, d_model) outputs whose all-gather they
    replace (experts × capacity ≈ tokens × k × capacity factor), and the
    sum over the k choices that follows is linear, so one reduction of the
    (tokens, d_model) output remains, as GSPMD lowers JAX's scatter-add.
    The gradient is each rank's slots added into x's shape, a partial sum
    where the slots are sharded; on a partial-sum dim it is taken whole and
    each rank adds the entries of its own shard. DTensor's own index
    gathers such a dim whole, and refuses, in some torch releases, an index
    that splits one dim over several mesh dims, and a backward
    (``index_put``) whose values have more dims than x."""
    return _Take.apply(x, *indices)


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
        if (isinstance(x, DTensor) and x.ndim >= 3 and w.ndim == 2
                and _flatten_refused(x, [range(x.ndim - 1)])):
            # x's leading dims, flattened by matmul: a product on shards
            lead = "abcdefgh"[:x.ndim - 1]
            return local_einsum(f"{lead}y,yz->{lead}z", x, w)
    elif func is torch.einsum:
        eq, ops = args[0], args[1:]
        if len(ops) == 1 and isinstance(ops[0], (list, tuple)):
            ops = tuple(ops[0])
        groups = (_einsum_groups(eq, [o.shape for o in ops])
                  if isinstance(eq, str) and len(ops) == 2 and not kwargs
                  and any(isinstance(o, DTensor) for o in ops) else None)
        if groups and (any(isinstance(o, DTensor) and _flatten_refused(o, gs)
                           for o, gs in zip(ops, groups))
                       or _batch_split(eq, ops)):
            return local_einsum(eq, *ops)
    elif func in (torch.cumsum, torch.Tensor.cumsum):
        x = args[0]
        dim = args[1] if len(args) > 1 else kwargs.get("dim")
        if (isinstance(x, DTensor) and isinstance(dim, int)
                and set(kwargs) <= {"dim"} and len(args) <= 2
                and torch.is_grad_enabled() and x.requires_grad
                and not sharded_on(x, dim)):
            return cumsum_local(x, dim % x.ndim)
    elif func is torch.Tensor.__getitem__:
        x, key = args
        key = key if isinstance(key, tuple) else (key,)
        ints = all(isinstance(i, torch.Tensor) and i.dtype != torch.bool
                   and not i.dtype.is_floating_point for i in key)
        # DTensor's own index serves elsewhere: its backward where x takes
        # no gradient, its forward where no index splits a dim and x is
        # sharded on no indexed dim (there it would take x's shard as a
        # partial sum of a gathered output, or gather x by another plan)
        if (isinstance(x, DTensor) and key and ints
                and ((torch.is_grad_enabled() and x.requires_grad)
                     or any(isinstance(i, DTensor) and _split_dims(i)
                            for i in key)
                     or any(isinstance(p, Shard) and p.dim < len(key)
                            for p in x.placements))):
            return take(x, *key)
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
