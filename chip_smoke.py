"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py              # needs one CUDA card; exits non-zero otherwise
    python3 chip_smoke.py --profile    # also writes a torch.profiler table of
                                       # two training steps to chiprun_out/

Phases, in order; any failure ends the run with a non-zero exit:
  1. build   compile the CUDA kernels from the sources in this checkout
             (one nvcc per source, started together) and print the time.
  2. kernels hold each kernel against its plain PyTorch version on the card
             at the main path's shapes (reddit-sim, 4 partitions, rcm layout;
             N(0,1) inputs at F = 128, 256, 16) with assert_close(rtol=1e-5,
             atol=1e-5), and time kernel, plain version and a library call
             (a block-sparse BSR product where PyTorch runs it for f32, else
             a dense matmul of the densified shard) with CUDA events.
  3. steps   2 training steps at dropout 0 through the kernels and 2 through
             the plain COO engine on the card; loss, grads and buffers agree
             to 1e-3 in relative Frobenius norm, ||a - b|| / ||b|| (f32
             through 4 layers with other summation orders, another matmul
             order in the last layer, and ReLU masks that may flip where a
             pre-activation lies within f32 rounding of 0: a flip moves a
             few elements by a discrete amount, so an elementwise bound
             would fail on correct code; a wrong tile moves the norm by far
             more).
  4. train   the main path: GraphDataPipeline.build + train_pipegcn on
             reddit-sim at full width (4 partitions, GraphSAGE, feat 128,
             hidden 256, 4 layers, 16 classes, variant pipegcn, blocksparse,
             matmul_order auto, dropout 0.5) for 5 epochs. The kernels' launch
             counts are zeroed just before and read just after; both must
             equal the counts the schedule implies (4 spmm + 3 spmm_t per
             training step, 4 spmm per evaluation).
Prints the card's name and power limit, one {"kernels": [...]} JSON line,
and last the {"ok": true, "device": {...}} line.
"""
from __future__ import annotations

import concurrent.futures
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
PEAK_F32_FLOPS = 67e12     # H100 SXM f32 outside the tensor cores (data sheet)
PEAK_BYTES = 3.35e12       # H100 SXM HBM3 bytes/s (data sheet)
EPOCHS = 5
EVAL_EVERY = 10


def log(msg: str):
    print(msg, flush=True)


def cuda_time_ms(fn, reps: int) -> float:
    """Mean device time of fn() over `reps` launches, after one warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_build():
    from repro_torch.kernels import _build
    sources = sorted(f[:-3] for f in os.listdir(_build.CSRC) if f.endswith(".cu"))
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
        results = dict(zip(sources, pool.map(_build.build, sources)))
    log(f"build: {len(sources)} CUDA sources in {time.perf_counter() - t0:.2f} s")
    for name, (path, report) in results.items():
        log(f"build: {name} -> {os.path.relpath(path, ROOT)}")
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {line.strip()}")


def _bsr_operand(topo, transpose: bool):
    """Block-diagonal BSR matrix of all partitions' nonzero tiles (P or Pᵀ),
    the same as dense (P, out, in) shards, and the padded input rows of
    one partition."""
    import torch
    P, n = topo.tile_rows.shape
    nrb = topo.tile_row_ptr.shape[1] - 1
    ncb = topo.tile_col_ptr.shape[1] - 1
    vals = topo.tile_vals
    keep = vals.abs().amax(dim=(-1, -2)) > 0
    part = torch.arange(P, device=vals.device)[:, None].expand(P, n)
    r = topo.tile_rows.long() + nrb * part
    c = topo.tile_cols.long() + ncb * part
    v = vals
    nrows, ncols = P * nrb, P * ncb
    if transpose:
        r, c, v = c, r, vals.transpose(-1, -2)
        nrows, ncols = ncols, nrows
    r, c, v = r[keep], c[keep], v[keep]
    order = torch.argsort(r * ncols + c)
    r, c, v = r[order], c[order], v[order].contiguous()
    crow = torch.zeros(nrows + 1, dtype=torch.int64, device=vals.device)
    crow[1:] = torch.cumsum(torch.bincount(r, minlength=nrows), 0)
    bsr = torch.sparse_bsr_tensor(crow, c, v, size=(nrows * 128, ncols * 128))
    dense = torch.zeros(P, nrows // P * 128, ncols // P * 128,
                        device=vals.device)
    rr, cc = r % (nrows // P), c % (ncols // P)
    pp = r // (nrows // P)
    dense_blocks = dense.view(P, nrows // P, 128, ncols // P, 128)
    dense_blocks[pp, rr, :, cc, :] = v
    return bsr, dense, ncols // P * 128


def _library_call(topo, transpose: bool):
    """One PyTorch call that computes the same product on a padded input:
    the BSR sparse product where it runs for f32 on this card, else the
    dense batched matmul of the densified shards. Returns (name, fn(x_pad))
    where x_pad is (P, in_rows, F) with in_rows the padded input rows."""
    import torch
    bsr, dense, in_rows = _bsr_operand(topo, transpose)
    probe = torch.zeros(dense.shape[0] * in_rows, 16, device=dense.device)
    try:
        # The yardstick is chosen here, not a phase result: a PyTorch
        # build without an f32 BSR product on CUDA takes the dense one.
        (bsr @ probe).sum().item()
    except (RuntimeError, NotImplementedError) as err:
        log(f"kernels: BSR product unavailable for f32 ({type(err).__name__}); "
            "library yardstick = dense bmm")
        return "dense_bmm", (lambda x: torch.bmm(dense, x)), in_rows
    return ("sparse_bsr_mm", (lambda x: bsr @ x.reshape(-1, x.shape[-1])),
            in_rows)


def phase_kernels(topo):
    """Kernels vs plain versions at the main path's shapes; timings."""
    import torch
    from repro_torch.kernels import gcn_spmm
    P, n = topo.tile_rows.shape
    R = topo.max_inner
    C = R + topo.halo_size
    n_nz = int((topo.tile_vals.abs().amax(dim=(-1, -2)) > 0).sum())
    gen = torch.Generator(device="cuda").manual_seed(0)
    libs = {False: _library_call(topo, False), True: _library_call(topo, True)}
    full = torch.full((P,), n, dtype=torch.int32, device="cuda")
    rows = {}
    for f in (128, 256, 16):
        h = torch.randn(P, C, f, device="cuda", generator=gen)
        dz = torch.randn(P, R, f, device="cuda", generator=gen)
        fwd = (lambda h=h: gcn_spmm.spmm(
            topo.tile_row_ptr, topo.tile_live, topo.tile_rows,
            topo.tile_cols, topo.tile_vals, h, R))
        fwd_plain = (lambda h=h: gcn_spmm.spmm_plain(
            topo.tile_rows, topo.tile_cols, topo.tile_vals, h, R))
        bwd = (lambda dz=dz: gcn_spmm.spmm_t(
            topo.tile_col_ptr, topo.tile_t_live, topo.tile_t_out,
            topo.tile_t_in, topo.tile_t_perm, topo.tile_vals, dz, C))
        bwd_plain = (lambda dz=dz: gcn_spmm.spmm_t_plain(
            topo.tile_t_out, topo.tile_t_in, topo.tile_t_perm,
            topo.tile_vals, dz, C))
        # the same kernels walking every stream slot (live length = stream
        # length), i.e. the zero padding tiles too, as the Pallas grid does
        fwd_full = (lambda h=h: gcn_spmm.spmm(
            topo.tile_row_ptr, full, topo.tile_rows, topo.tile_cols,
            topo.tile_vals, h, R))
        bwd_full = (lambda dz=dz: gcn_spmm.spmm_t(
            topo.tile_col_ptr, full, topo.tile_t_out, topo.tile_t_in,
            topo.tile_t_perm, topo.tile_vals, dz, C))
        for name, kern, kern_full, plain, x, in_rows, out_rows, tr in (
                ("spmm", fwd, fwd_full, fwd_plain, h, C, R, False),
                ("spmm_t", bwd, bwd_full, bwd_plain, dz, R, C, True)):
            got, want = kern(), plain()
            torch.cuda.synchronize()
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
            assert torch.equal(kern_full(), got)
            # A/B in turns (cut, full, full, cut) inside this one run
            ab = [cuda_time_ms(k, 20) for k in (kern, kern_full, kern_full, kern)]
            err = float((got - want).abs().max())
            lib_name, lib_fn, in_pad = libs[tr]
            lib_in = _pad_rows(x, in_pad)
            lib_out = lib_fn(lib_in).reshape(P, -1, f)[:, :out_rows]
            lib_err = float((lib_out - want).abs().max())
            flops = 2.0 * n_nz * 128 * 128 * f
            nbytes = (n_nz * 128 * 128 * 4 + P * in_rows * f * 4
                      + P * out_rows * f * 4)
            t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
            row = dict(f=f, max_abs_err=err,
                       ms=(ab[0] + ab[3]) / 2,
                       ms_full_stream=(ab[1] + ab[2]) / 2, ab_ms=ab,
                       plain_ms=cuda_time_ms(plain, 5),
                       library=lib_name,
                       library_ms=cuda_time_ms(lambda: lib_fn(lib_in), 10),
                       library_max_abs_err=lib_err,
                       bound_ms=1e3 * max(t_ops, t_bytes),
                       bound_by="operations" if t_ops >= t_bytes else "bytes",
                       gflop=flops / 1e9, mbytes=nbytes / 1e6)
            rows.setdefault(name, []).append(row)
            log(f"kernels: {name} F={f} max_abs_err {err:.3g} "
                f"kernel {row['ms']:.4f} ms (full stream "
                f"{row['ms_full_stream']:.4f} ms) plain {row['plain_ms']:.4f} ms "
                f"{lib_name} {row['library_ms']:.4f} ms "
                f"bound {row['bound_ms']:.4f} ms ({row['bound_by']})")
    log(f"kernels: {n_nz} nonzero 128x128 tiles over {P} partitions "
        f"({n} stream slots each)")
    return rows


def _pad_rows(x, rows: int):
    """(P, r, F) -> (P, rows, F), zero-padded to the tile grid."""
    import torch
    pad = rows - x.shape[1]
    return torch.cat([x, x.new_zeros(x.shape[0], pad, x.shape[2])], 1) if pad else x


def _rel_close(a, b, what, rel=1e-3):
    """||a - b|| / ||b|| <= rel (Frobenius); returns the ratio."""
    import torch
    assert torch.isfinite(a).all(), f"{what}: non-finite values"
    scale = float(torch.linalg.vector_norm(b.double()))
    diff = float(torch.linalg.vector_norm((a - b).double()))
    assert diff <= rel * scale, \
        f"{what}: ||diff|| {diff:.3g} > {rel} x ||ref|| {scale:.3g}"
    return diff / scale if scale else 0.0


def phase_steps(pipeline):
    """2 training steps through the kernels vs 2 through the COO engine."""
    import torch
    from repro_torch.core import ModelConfig, PipeConfig, PipeGCN
    ds = pipeline.dataset
    worst = 0.0
    models = {agg: PipeGCN(ModelConfig(kind="sage", feat_dim=ds.feat_dim,
                                       hidden=256, num_layers=4,
                                       num_classes=ds.num_classes,
                                       dropout=0.0, agg=agg,
                                       matmul_order="auto"),
                           PipeConfig.named("pipegcn"))
              for agg in ("blocksparse", "coo")}
    params0 = models["coo"].init_params(
        torch.Generator(device="cuda").manual_seed(0))
    state = {agg: (dict(params0), m.init_buffers(pipeline.topo))
             for agg, m in models.items()}
    for t in range(2):
        out = {}
        for agg, m in models.items():
            params, bufs = state[agg]
            loss, grads, bufs, logits = m.train_step(
                pipeline.topo, params, bufs, pipeline.train_data)
            out[agg] = (loss, grads, bufs, logits)
            state[agg] = ({k: params[k] - 0.01 * grads[k] for k in params},
                          bufs)
        (lk, gk, bk, zk), (lp, gp, bp, zp) = out["blocksparse"], out["coo"]
        assert zk.shape == (4, pipeline.topo.max_inner, ds.num_classes)
        worst = max(worst, _rel_close(lk.reshape(1), lp.reshape(1),
                                      f"step {t} loss"))
        for k in gp:
            worst = max(worst, _rel_close(gk[k], gp[k], f"step {t} grad {k}"))
        for kind in ("feat", "grad"):
            for ell, (a, b) in enumerate(zip(bk[kind], bp[kind])):
                worst = max(worst, _rel_close(a, b, f"step {t} {kind}[{ell}]"))
        log(f"steps: step {t} loss kernels {float(lk):.6f} "
            f"plain-coo {float(lp):.6f}")
    log(f"steps: loss, grads and buffers agree (worst relative norm diff "
        f"{worst:.3g} <= 1e-3)")
    return worst


def phase_train(pipeline):
    """The main path, with the launch counts zeroed just before it."""
    from repro_torch.core import ModelConfig, PipeConfig, PipeGCN, train_pipegcn
    from repro_torch.graph.synthetic import model_template
    from repro_torch.kernels import gcn_spmm
    ds = pipeline.dataset
    tpl = model_template("reddit-sim")
    mc = ModelConfig(kind="sage", feat_dim=ds.feat_dim, hidden=tpl["hidden"],
                     num_layers=tpl["num_layers"], num_classes=ds.num_classes,
                     dropout=tpl["dropout"], multilabel=ds.multilabel,
                     agg="blocksparse", matmul_order="auto",
                     layout=pipeline.layout)
    assert (mc.feat_dim, mc.hidden, mc.num_layers, mc.num_classes,
            mc.dropout) == (128, 256, 4, 16, 0.5)
    gcn_spmm.spmm.launches = 0
    gcn_spmm.spmm_t.launches = 0
    res = train_pipegcn(pipeline, mc, PipeConfig.named("pipegcn"),
                        epochs=EPOCHS, lr=tpl["lr"], seed=0,
                        eval_every=EVAL_EVERY, log=lambda s: log(f"train: {s}"),
                        device="cuda")
    launches = {"spmm": gcn_spmm.spmm.launches,
                "spmm_t": gcn_spmm.spmm_t.launches}
    n_eval = len(res.history["epoch"])
    # every layer aggregates once per step and per eval; the backward
    # transposes every layer but layer 0 (Alg. 1 stops there), which needs
    # Pᵀ·du only for a transform-first weight gradient
    L = mc.num_layers
    first_tf = PipeGCN(mc, PipeConfig.named("pipegcn")).layer_orders(
        pipeline.topo)[0] == "transform-first"
    expect = {"spmm": L * EPOCHS + L * n_eval,
              "spmm_t": (L - 1 + first_tf) * EPOCHS}
    assert all(math.isfinite(v) for v in res.history["loss"]), res.history
    assert launches == expect, (launches, expect)
    log(f"train: loss {res.history['loss'][-1]:.4f} val "
        f"{res.final_metrics['val']:.4f} epochs/s {res.epochs_per_sec:.3f} "
        f"launches {launches} ({EPOCHS} steps, {n_eval} evals)")
    return res, launches


def phase_profile(pipeline):
    """Optional: torch.profiler table of two training steps, written under
    chiprun_out/; prints the device time per kernel name."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import (HealthConfig, ModelConfig, PipeConfig,
                                  PipeGCN, make_train_step)
    from repro_torch.optim import adam
    ds = pipeline.dataset
    model = PipeGCN(ModelConfig(kind="sage", feat_dim=ds.feat_dim, hidden=256,
                                num_layers=4, num_classes=ds.num_classes,
                                dropout=0.5, agg="blocksparse",
                                matmul_order="auto"),
                    PipeConfig.named("pipegcn"))
    gen = torch.Generator(device="cuda").manual_seed(1)
    params = model.init_params(torch.Generator(device="cuda").manual_seed(0))
    opt = adam(0.01)
    st, bufs = opt.init(params), model.init_buffers(pipeline.topo)
    step = make_train_step(model, opt, HealthConfig())
    for _ in range(2):
        _, params, st, bufs, _ = step(pipeline.topo, params, st, bufs,
                                      pipeline.train_data, gen)
    torch.cuda.synchronize()
    times = []
    for _ in range(20):
        t0 = time.perf_counter()
        _, params, st, bufs, _ = step(pipeline.topo, params, st, bufs,
                                      pipeline.train_data, gen)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    q = sorted(times)
    log(f"profile: train step ms over {len(q)} steps: median "
        f"{(q[9] + q[10]) / 2:.3f} quartiles {q[4]:.3f} {q[14]:.3f} "
        f"max {q[-1]:.3f}")
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            _, params, st, bufs, _ = step(pipeline.topo, params, st, bufs,
                                          pipeline.train_data, gen)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    table = prof.key_averages().table(sort_by="cuda_time_total", row_limit=40)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "profile_step.txt"), "w") as f:
        f.write(table)
    # device-side events only (kernels, copies): an operator row also
    # carries the device time of the kernels it launched
    events = [e for e in prof.key_averages()
              if getattr(e, "device_type", None) == DeviceType.CUDA]

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))
    total = sum(dev_us(e) for e in events)
    top = sorted(events, key=dev_us, reverse=True)[:12]
    log("profile: " + json.dumps({
        "steps": 2, "wall_ms_profiled": wall * 1e3,
        "device_busy_ms": total / 1e3,
        "top": [[e.key[:60], dev_us(e) / 1e3, e.count] for e in top]}))


def nvidia_smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def main(argv) -> int:
    import torch
    if not torch.cuda.is_available():
        log("chip_smoke: torch.cuda.is_available() is False; this script "
            "needs one CUDA card")
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.data import GraphDataPipeline
    from repro_torch.kernels import gcn_spmm
    from repro_torch.core.pipegcn import exact_f32_matmul
    exact_f32_matmul()
    t_start = time.perf_counter()
    log(f"device: {torch.cuda.get_device_name(0)} (torch {torch.__version__}, "
        f"CUDA {torch.version.cuda})")
    phase_build()
    t0 = time.perf_counter()
    pipeline = GraphDataPipeline.build("reddit-sim", 4, kind="sage",
                                       agg="blocksparse", layout="auto",
                                       device="cuda")
    topo = pipeline.topo
    log(f"pipeline: reddit-sim P=4 layout={pipeline.layout} max_inner "
        f"{topo.max_inner} halo {topo.halo_size} combined "
        f"{topo.max_inner + topo.halo_size} n_tiles {topo.tile_rows.shape[1]} "
        f"built in {time.perf_counter() - t0:.2f} s")
    rows = phase_kernels(topo)
    phase_steps(pipeline)
    res, launches = phase_train(pipeline)
    if "--profile" in argv:
        phase_profile(pipeline)
    sources = {"spmm": ("repro/kernels/gcn_spmm.py:110 spmm_block_sparse "
                        "(pallas_call :126, kernel _kernel :85)"),
               "spmm_t": ("repro/kernels/gcn_spmm.py:182 spmm_block_sparse_t "
                          "(pallas_call :200, kernel _kernel_t :151)")}
    kernels = []
    for name in ("spmm", "spmm_t"):
        main_row = next(r for r in rows[name] if r["f"] == 256)
        err = max(r["max_abs_err"] for r in rows[name])
        kernels.append(dict(
            name=name, route="cuda",
            source="src/repro_torch/kernels/csrc/gcn_spmm.cu",
            replaces="src/" + sources[name].split(" ")[0],
            launches=launches[name], max_abs_err=err, max_err=err,
            ms=main_row["ms"], kernel_ms=main_row["ms"],
            plain_ms=main_row["plain_ms"], bound_ms=main_row["bound_ms"],
            bound_by=main_row["bound_by"],
            library_ms=main_row["library_ms"], library=main_row["library"],
            at_f=256, per_f=rows[name]))
    log(f"total: {time.perf_counter() - t_start:.1f} s "
        f"(spmm launches per run {gcn_spmm.spmm.launches})")
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
