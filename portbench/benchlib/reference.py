"""Plain-PyTorch reference of PipeGCN training (Wan et al., ICLR 2022,
Alg. 1) on the benchmark's own graph substrate, and the comparison that
decides a run's ``correct``.

Imports torch, numpy and the benchmark's own modules only: nothing of the
program. The reference follows the first steps of a training run from the
seed, as the program does, in float32 with TF32 off:

- parameters: Glorot-scaled normal weights drawn in layer order from a
  ``torch.Generator`` on the device seeded with ``seed``, zero biases;
- dropout: per step and layer, ``torch.rand((P, combined, fin)) >= rate``
  on a generator seeded with ``seed + 1``, over each partition's combined
  [inner; halo] rows, scaled by 1 / (1 - rate);
- one-step-stale boundary features (layer inputs of the previous step,
  zero at the first) and boundary gradients (Alg. 1), exchanged between
  partitions;
- GraphSAGE layers u = (P·comb)·W_neigh + b + comb_inner·W_self, ReLU
  between layers, no backward through layer 0's aggregation;
- masked softmax cross-entropy, or sigmoid BCE for multilabel, over the
  training nodes of all partitions;
- Adam (β = 0.9, 0.999, ε = 1e-8) with bias correction.

The aggregation is ``torch.sparse`` CSR times dense, one block-diagonal
matrix over all partitions.

``faults`` plants the errors the comparison has to catch in the reference
put in the program's place: "tf32" rounds every dense product's operands
to TF32 (10 mantissa bits, the next precision below float32), "half_batch"
takes the loss over the first half of the training nodes only,
"no_exchange" never delivers a boundary payload.
"""
from __future__ import annotations

import math
import statistics

import numpy as np
import torch

B1, B2, EPS = 0.9, 0.999, 1e-8
FAULTS = ("tf32", "half_batch", "no_exchange")
# the numbers `compare` gives that decide a run's ``correct``, in order
COMPARED = ("first_loss_gap", "later_loss_gap", "grad_gap", "change_gap")


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10 mantissa bits (to nearest, ties away
    from zero), as the tensor cores round a TF32 operand."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def layer_dims(model: dict) -> list[tuple[int, int]]:
    dims = ([model["feat_dim"]] + [model["hidden"]] * (model["num_layers"] - 1)
            + [model["num_classes"]])
    return [(dims[i], dims[i + 1]) for i in range(model["num_layers"])]


def init_params(model: dict, generator: torch.Generator) -> dict:
    dev = generator.device
    params = {}
    for ell, (fin, fout) in enumerate(layer_dims(model)):
        fan_in = 2 * fin
        scale = float(np.sqrt(2.0 / (fan_in + fout)))
        params[f"w{ell}"] = torch.randn(fan_in, fout, generator=generator,
                                        device=dev) * scale
        params[f"b{ell}"] = torch.zeros(fout, device=dev)
    return params


class Reference:
    """The substrate's tensors on `device`, built once and stepped from
    any seed."""

    def __init__(self, layout, data, model: dict, device,
                 dtype=torch.float32):
        self.dev = torch.device(device)
        self.dtype = dtype
        self.lay = layout
        self.model = model
        p, mi, comb = layout.num_parts, layout.max_inner, layout.combined
        rows, cols, vals = [], [], []
        for i in range(p):
            rows.append(layout.edge_row[i] + i * mi)
            cols.append(layout.edge_col[i] + i * comb)
            vals.append(layout.edge_w[i])
        r = torch.from_numpy(np.concatenate(rows))
        c = torch.from_numpy(np.concatenate(cols))
        v = torch.from_numpy(np.concatenate(vals)).to(dtype)
        self.A = self._csr(r, c, v, (p * mi, p * comb))
        self.At = self._csr(c, r, v, (p * comb, p * mi))
        src = torch.from_numpy(layout.comb_src.reshape(-1))
        halo = torch.from_numpy(layout.is_halo.reshape(-1))
        self.own_rows = torch.nonzero((src >= 0) & ~halo)[:, 0].to(self.dev)
        self.own_src = src[(src >= 0) & ~halo].to(self.dev)
        self.halo_rows = torch.nonzero(halo)[:, 0].to(self.dev)
        self.halo_src = src[halo].to(self.dev)
        inner = np.concatenate([np.arange(i * mi, i * mi + layout.inner_count[i])
                                for i in range(p)])
        node = np.full(p * mi, -1, dtype=np.int64)
        node[layout.part * mi + layout.local_of] = np.arange(len(layout.part))
        self.real = torch.from_numpy(inner).to(self.dev)
        nodes = node[inner]
        self.x = torch.zeros(p * mi, data.features.shape[1], device=self.dev,
                             dtype=dtype)
        self.x[self.real] = torch.from_numpy(data.features[nodes]).to(
            self.dev, dtype)
        lab = torch.from_numpy(data.labels[nodes]).to(self.dev)
        self.labels = lab.to(dtype) if model["multilabel"] else lab.long()
        self.train = torch.from_numpy(data.train_mask[nodes]).to(self.dev)

    def _csr(self, r, c, v, shape):
        order = torch.from_numpy(np.lexsort((c.numpy(), r.numpy())))
        r, c, v = r[order], c[order], v[order]
        crow = torch.zeros(shape[0] + 1, dtype=torch.int64)
        crow[1:] = torch.cumsum(torch.bincount(r, minlength=shape[0]), 0)
        return torch.sparse_csr_tensor(crow, c, v, size=shape).to(self.dev)

    def _comb(self, h, h_stale):
        """(P·combined, F): own rows from this step's h, halo rows from the
        previous step's."""
        out = h.new_zeros(self.lay.num_parts * self.lay.combined, h.shape[1])
        out[self.own_rows] = h[self.own_src]
        out[self.halo_rows] = h_stale[self.halo_src]
        return out

    def _inner(self, comb):
        p, mi = self.lay.num_parts, self.lay.max_inner
        return comb.reshape(p, self.lay.combined, -1)[:, :mi].reshape(p * mi, -1)

    def _loss(self, logits, train):
        lg = logits[self.real]
        t = train.to(lg.dtype)
        y = self.labels
        if self.model["multilabel"]:
            total = torch.clamp(t.sum() * lg.shape[1], min=1.0)
            per = torch.clamp(lg, min=0) - lg * y + torch.log1p(torch.exp(-lg.abs()))
            loss = (per * t[:, None]).sum() / total
            d = (torch.sigmoid(lg) - y) * t[:, None] / total
        else:
            total = torch.clamp(t.sum(), min=1.0)
            lse = torch.logsumexp(lg, dim=-1)
            ll = torch.gather(lg, 1, y[:, None])[:, 0]
            loss = ((lse - ll) * t).sum() / total
            onehot = torch.nn.functional.one_hot(y, lg.shape[1]).to(lg.dtype)
            d = (torch.softmax(lg, dim=-1) - onehot) * t[:, None] / total
        dlogits = logits.new_zeros(logits.shape)
        dlogits[self.real] = d
        return loss, dlogits

    def run(self, seed: int, steps: int = 3, faults=()) -> dict:
        """The first `steps` training steps from `seed`: each step's loss,
        the first step's gradients, the initial and the final parameters."""
        for f in faults:
            if f not in FAULTS:
                raise ValueError(f"unknown fault {f!r}; have {FAULTS}")
        torch.backends.cuda.matmul.allow_tf32 = False
        tf32 = "tf32" in faults

        def mm(a, b):
            return round_tf32(a) @ round_tf32(b) if tf32 else a @ b

        m = self.model
        L = m["num_layers"]
        rate = float(m["dropout"])
        dims = layer_dims(m)
        lay = self.lay
        p, comb_n = lay.num_parts, lay.combined
        train = self.train
        if "half_batch" in faults:
            idx = torch.nonzero(train)[:, 0]
            train = train.clone()
            train[idx[len(idx) // 2:]] = False
        with torch.no_grad():
            params = {k: v.to(self.dtype) for k, v in init_params(
                m, torch.Generator(device=self.dev).manual_seed(seed)).items()}
            params0 = dict(params)
            gen = torch.Generator(device=self.dev).manual_seed(seed + 1)
            mu = {k: torch.zeros_like(v) for k, v in params.items()}
            nu = {k: torch.zeros_like(v) for k, v in params.items()}
            feat = [torch.zeros(p * lay.max_inner, fin, device=self.dev,
                                dtype=self.dtype) for fin, _ in dims]
            grad = [torch.zeros_like(f) for f in feat]
            losses, grads1 = [], None
            for t in range(1, steps + 1):
                h = self.x
                res, inputs = [], []
                for ell, (fin, _) in enumerate(dims):
                    w, b = params[f"w{ell}"], params[f"b{ell}"]
                    comb = self._comb(h, feat[ell])
                    mask = None
                    if rate > 0.0:
                        keep = torch.rand((p, comb_n, fin), generator=gen,
                                          device=self.dev) >= rate
                        mask = (keep.to(torch.float32) / (1.0 - rate)
                                ).to(self.dtype).reshape(-1, fin)
                        comb = comb * mask
                    z = self.A @ comb
                    u = mm(z, w[:fin]) + b + mm(self._inner(comb), w[fin:])
                    res.append((comb, z, u, mask))
                    inputs.append(h)
                    h = torch.relu(u) if ell < L - 1 else u
                loss, j = self._loss(h, train)
                losses.append(float(loss))
                g = {}
                new_grad = list(grad)
                for ell in reversed(range(L)):
                    comb, z, u, mask = res[ell]
                    fin = dims[ell][0]
                    w = params[f"w{ell}"]
                    du = j if ell == L - 1 else j * (u > 0).to(j.dtype)
                    g[f"b{ell}"] = du.sum(0)
                    g[f"w{ell}"] = torch.cat([mm(z.T, du),
                                              mm(self._inner(comb).T, du)], 0)
                    if ell == 0:
                        break
                    dcomb = self.At @ mm(du, w[:fin].T)
                    dcomb = dcomb.reshape(p, comb_n, fin)
                    dcomb[:, :lay.max_inner] += mm(du, w[fin:].T).reshape(
                        p, lay.max_inner, fin)
                    dcomb = dcomb.reshape(-1, fin)
                    if mask is not None:
                        dcomb = dcomb * mask
                    fresh = torch.zeros_like(grad[ell])
                    fresh.index_add_(0, self.halo_src, dcomb[self.halo_rows])
                    j = self._inner(dcomb) + grad[ell]
                    new_grad[ell] = fresh
                if "no_exchange" not in faults:
                    feat, grad = inputs, new_grad
                if grads1 is None:
                    grads1 = g
                b1t = 1 - torch.tensor(B1) ** torch.tensor(float(t))
                b2t = 1 - torch.tensor(B2) ** torch.tensor(float(t))
                lr = float(m["lr"])
                for k in params:
                    mu[k] = B1 * mu[k] + (1 - B1) * g[k]
                    nu[k] = B2 * nu[k] + (1 - B2) * torch.square(g[k])
                    delta = (mu[k] / b1t.to(self.dev)) / (
                        torch.sqrt(nu[k] / b2t.to(self.dev)) + EPS)
                    params[k] = params[k] - lr * delta
        return {"losses": losses, "grads1": grads1, "params0": params0,
                "params": params}


def _norms(tree: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in tree.items()}


def compare(prog: dict, ref: dict) -> dict:
    """The numbers a run is judged by (`COMPARED`), from the program's
    first steps (``losses``, ``grads1``, ``params0``, ``params``) and the
    reference's.

    - first_loss_gap: |loss_prog - loss_ref| / |loss_ref| of the first step;
    - later_loss_gap: the same, the worst of the later steps;
    - grad_gap: per leaf, the gap between the program's norm of the first
      gradient and the reference's, against the reference's norm of that
      leaf or of the median leaf, whichever is larger; of the worst leaf;
    - change_gap: the same gap for the parameters' change over the steps,
      of the worst leaf.

    The first step's loss has a number of its own: it holds no Adam update,
    so round-off stays at an ulp there, while Adam's first update moves
    every element by about lr whatever its gradient, and an element whose
    gradient lies at round-off (the two sides give it opposite signs) lands
    2·lr away, which the later losses and the changes carry.
    Leaves whose reference gradient is under a thousandth of the median
    leaf's are left out (they move by round-off alone). ``detail`` keeps
    every leaf, each step and the median leaves."""
    losses = [abs(a - b) / max(abs(b), 1e-30)
              for a, b in zip(prog["losses"], ref["losses"])]
    finite = len(prog["losses"]) == len(ref["losses"]) and all(
        map(math.isfinite, prog["losses"]))
    gr, gp = _norms(ref["grads1"]), _norms(prog["grads1"])
    med = statistics.median(gr.values())
    kept = [k for k in gr if gr[k] >= 1e-3 * med]
    dev = ref["params"][kept[0]].device
    dr = _norms({k: ref["params"][k] - ref["params0"][k] for k in kept})
    dp = _norms({k: prog["params"][k].to(dev) - prog["params0"][k].to(dev)
                 for k in kept})
    dmed = statistics.median(dr.values())

    def gaps(pn, rn, median):
        return {k: abs(pn[k] - rn[k]) / max(rn[k], median) for k in rn}

    grad = gaps({k: gp[k] for k in kept}, {k: gr[k] for k in kept}, med)
    change = gaps(dp, dr, dmed)

    def sound(x):
        return x if finite and math.isfinite(x) else math.inf

    return {"first_loss_gap": sound(losses[0]),
            "later_loss_gap": sound(max(losses[1:], default=0.0)),
            "grad_gap": sound(max(grad.values())),
            "change_gap": sound(max(change.values())),
            "left_out": sorted(set(gr) - set(kept)),
            "detail": {"loss_steps": losses, "grad_leaf": grad,
                       "median_grad": statistics.median(grad.values()),
                       "change_leaf": change,
                       "median_change": statistics.median(change.values())}}
