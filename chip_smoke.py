"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py              # needs one CUDA card; exits non-zero otherwise
    python3 chip_smoke.py --profile    # also writes torch.profiler tables of
                                       # two training steps to chiprun_out/

Phases, in order; any failure ends the run with a non-zero exit:
  1. build   compile the CUDA kernels from the sources in this checkout
             (one nvcc per source, started together) and print the time;
             read every spmm and flash-attention kernel instance's
             registers, spills and tensor-core instructions from the
             libraries (cuobjdump -res-usage, -sass): it fails on a spmm
             HMMA that is not TF32, and on a flash instance that spills,
             a bf16 one without HMMA.16816.F32.BF16 (or with another HMMA)
             and an f32 one without HMMA or with one that is not TF32.
  1a. attention  the flash-attention kernel behind ops.attention, fed by the
             port's attention layer (projections, qk-norm, RoPE; numpy-
             seeded, x ~ N(0, 1), B = 1) at the full head widths of
             qwen3-8b (H 32, K 8, d 128; f32 and bf16), starcoder2-3b (H 24,
             K 2, d 128, window 4096) and recurrentgemma-2b (H 10, K 1,
             d 256, window 2048), causal at S = 8192, and qwen3-8b not
             causal at S = 4096. The layers run through the kernel with the
             launch counts zeroed just before and read just after (one
             launch per call); each output is held against
             flash_attention_plain (f32 rtol = atol = 2e-5, the JAX kernel
             tests' bar; bf16 atol 5e-2, their bar, and every row within
             1e-2 of its norm), against blockwise_attention (f32 2e-5; bf16
             rows within 3e-2: it rounds the scores to bf16, as in JAX), and
             the layer (kernel output @ wo) against the port's
             self_attention (blockwise at 8192, dense at 4096; f32 relative
             Frobenius norm <= 1e-5, bf16 rows within 3e-2), and two more
             launches bitwise equal to the main path's output. Kernel,
             plain version and scaled_dot_product_attention (the
             yardstick: in f32 its memory-efficient backend on k and v
             repeated to H heads, in bf16 the backend it picks; the
             backend is printed) are timed with CUDA events. Each row
             gives bound_ms on the tensor cores the kernel uses (bf16:
             flops / 989 TFLOP/s; f32: 3·flops / 495 TFLOP/s, 3×TF32),
             bound_fma_ms (flops / 67 TFLOP/s) beside it, bound_share =
             bound_ms / ms, and the instance's registers and spill bytes.
  2. kernels hold each kernel against its plain PyTorch version on the card
             at the main paths' shapes (reddit-sim and yelp-sim, 4
             partitions; yelp-sim 2 and grid-sim 4 partitions for the
             split; rcm layout; N(0,1) inputs) and time kernel, plain
             version and a yardstick with CUDA events:
             - spmm / spmm_t at every width the main paths run them at
               (reddit-sim F = 128, 256, 16; yelp-sim F = 120, 512, 24),
               assert_close(rtol=1e-5, atol=1e-5), and bit-equal to the
               same kernels on the schedules that walk every stream slot
               (zero tiles too); yardstick a library call (a block-sparse
               BSR product where PyTorch runs it for f32, else a dense
               matmul of the densified shard). Each call prints what it
               walks: work items, tiles walked (asserted equal to the
               nonzero tiles), the longest item (at most SCHED_CHUNK), and
               its kernel instance's registers, shared memory and TF32
               tensor-core instructions (phase build reads them from the
               library with cuobjdump, and fails on a non-TF32 HMMA);
             - spmm_fused at every shape the fused runs launch it at
               (F_in→F_out, reddit-sim: 128→256, 256→256 and 256→16, each
               with and without z, 128→256 and 256→256 also with the ReLU
               epilogue; yelp-sim: 120→512 with and without z, 512→512);
               spmm_fused_t at F_in←F_out 256←256, 256←16, 16←256 and
               512←512; gcn_spmm.assert_close_to_scale (rtol=1e-5, atol =
               1e-5·max|plain|: two chained f32 contractions, K up to
               512); yardstick the composed path: the port's spmm /
               spmm_t kernel plus torch.matmul, the same function unfused;
             - spmm_phased / spmm_t_phased, both phases, at every width the
               split paths launch them at (yelp-sim P=2 and grid-sim P=4),
               in-phase rows within rtol = atol = 1e-5 of the plain phased
               versions, launched into a NaN output (every in-phase row
               finite, every other row still NaN), boundary + interior
               bit-equal to the unsplit kernel; times per phase beside the
               unsplit kernel's; yardstick the BSR product of each phase's
               tiles.
  3. steps   2 training steps at dropout 0 through the kernels (f32) and 2
             through the plain COO engine in float64 on the card (an exact
             reference: the bound is the kernel path's own error), at each
             dataset's full-width GraphSAGE model: reddit-sim with
             agg=blocksparse (auto order)
             and agg=fused (aggregate-first, which runs spmm_fused_t, and
             auto), yelp-sim with agg=fused (auto); plus one reddit-sim GCN
             eval forward through the fused kernels (in-kernel ReLU); loss,
             grads and buffers agree to STEP_REL = 5e-4 in relative
             Frobenius norm, ||a - b|| / ||b|| (f32 through 4 layers with
             other summation orders, and ReLU masks that may flip where a
             pre-activation lies within f32 rounding of 0: a flip moves a
             few elements by a discrete amount, so an elementwise bound
             would fail on correct code; a wrong tile moves the norm by
             far more). The COO engine in f32 runs beside them, and its
             reading against the f64 reference is printed with theirs.
  4. split   the split-phase step at full width, 2 steps at dropout 0 on
             yelp-sim P=2 (GraphSAGE, feat 120, hidden 512, 4 layers, BCE)
             and grid-sim P=4 (feat 32, hidden 64, 3 layers): the
             blocksparse split bit-equal to the unsplit step, fused/auto
             (the composed phased path) bit-equal to the blocksparse
             split, exact launch counts.
  5. spmd    the torch.distributed backend with NCCL at world size 1, the 4
             grid-sim partitions co-resident (hierarchical exchange,
             n_dev = 1), unsplit and split, 2 steps each against the sim
             backend (bitwise, else within 1e-6 relative norm, printed),
             and 3 epochs of train_pipegcn on it against the sim trainer.
  6. train   the main paths: GraphDataPipeline.build + train_pipegcn for 5
             epochs each, at full width:
             - reddit-sim (4 partitions, GraphSAGE, feat 128, hidden 256, 4
               layers, 16 classes, variant pipegcn, dropout 0.5), with
               agg=blocksparse / auto, agg=fused / auto and agg=fused /
               aggregate-first;
             - yelp-sim (4 partitions, GraphSAGE, feat 120, hidden 512, 4
               layers, 24 classes multilabel BCE, F1 metric, dropout 0.1),
               agg=fused / auto;
             - the split: yelp-sim P=2 with agg=blocksparse / auto and
               agg=fused / auto, grid-sim P=4 with agg=blocksparse / auto.
             Every kernel's launch count is zeroed just before each run and
             read just after; the counts must equal those the run's layer
             orders imply (see expected_launches).
  7. step    median train-step time (device sync after each step) of
             reddit-sim and yelp-sim with agg=blocksparse and agg=fused
             (auto order), and of yelp-sim P=2 and grid-sim P=4 unsplit
             and split, timed in turns within this run.
  8. overlap torch.profiler trace of 3 split steps per split graph: the
             share of the side-stream exchange copies' device time that
             lies inside the interior-phase kernel on the compute stream
             (the traces are kept under build/traces/).
Bounds of the GCN kernels (spmm pair, phased pair, fused pair) and of
flash attention in f32: bound_ms = max(bytes / 3.35 TB/s, 3·flops / 495
TFLOP/s), the least time of f32-accurate (3×TF32) work on the tensor
cores; flash attention in bf16: flops / 989 TFLOP/s; bound_fma_ms beside
it counts the flops at the f32 FMA rate of 67 TFLOP/s.
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
PEAK_TF32_FLOPS = 495e12   # H100 SXM TF32 tensor cores, dense (data sheet)
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


# (transpose, FB) -> registers of that spmm kernel instance and its count
# of TF32 tensor-core instructions (cuobjdump -res-usage and -sass)
SPMM_BUILD = {}
# (head dim, dtype) -> registers, spill bytes and tensor-core instructions
# of that flash-attention kernel instance
FLASH_BUILD = {}


def phase_build():
    import re
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
    # registers, spills and tensor-core instructions of every kernel
    # instance, read from the built libraries (also from the build cache)
    inst = re.compile(r"spmm_items_kernelILb([01])ELi(\d+)E")
    res = _build.kernel_resources(results["gcn_spmm"][0])
    ops = _build.tensor_core_ops(results["gcn_spmm"][0])
    found = {}
    for name, r in res.items():
        m = inst.search(name)
        if m:
            found[m.group(1) == "1", int(m.group(2))] = (r, ops.get(name, {}))
    assert len(found) == 10 and all(o for _, o in found.values()), found
    for key, (r, o) in sorted(found.items()):
        assert all("TF32" in op for op in o), (key, o)
        SPMM_BUILD[key] = (r["registers"], sum(o.values()))
        log(f"build: spmm_items_kernel<transpose={key[0]}, FB={key[1]}>: "
            f"{r['registers']} registers, SASS tensor-core ops {o}")
    inst = re.compile(r"flash_attention_kernelILi(\d+)E(13__nv_bfloat16|f)E")
    res = _build.kernel_resources(results["flash_attention"][0])
    ops = _build.tensor_core_ops(results["flash_attention"][0])
    for name, r in res.items():
        m = inst.search(name)
        if not m:
            continue
        key = (int(m.group(1)), "float32" if m.group(2) == "f" else "bfloat16")
        o = ops.get(name, {})
        FLASH_BUILD[key] = dict(registers=r["registers"],
                                spill_bytes=r["stack"] + r["local"],
                                tensor_core_ops=o)
        log(f"build: flash_attention_kernel<D={key[0]}, {key[1]}>: "
            f"{r['registers']} registers, stack + local (spills) "
            f"{r['stack'] + r['local']} bytes, SASS tensor-core ops {o}")
        assert r["stack"] == 0 and r["local"] == 0, (key, r)
        if key[1] == "bfloat16":
            assert o.get("HMMA.16816.F32.BF16") and all(
                op.endswith(".BF16") for op in o), (key, o)
        else:
            assert o and all(op.endswith(".TF32") for op in o), (key, o)
    assert sorted(FLASH_BUILD) == sorted(
        (d, t) for d in (32, 64, 128, 256) for t in ("float32", "bfloat16")), \
        sorted(FLASH_BUILD)


def gcn_bound(flops: float, nbytes: float) -> dict:
    """The least time of a GCN kernel at f32 accuracy: the larger of the
    bytes at the memory rate and 3×TF32 on the tensor cores (3·flops at
    495 TFLOP/s); beside it bound_fma_ms, the f32-FMA figure (flops at 67
    TFLOP/s) these rows were held to before the tensor-core kernels."""
    t_ops, t_bytes = 3 * flops / PEAK_TF32_FLOPS, nbytes / PEAK_BYTES
    return dict(bound_ms=1e3 * max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                bound_fma_ms=1e3 * max(flops / PEAK_F32_FLOPS, t_bytes),
                gflop=flops / 1e9, mbytes=nbytes / 1e6)


def schedule_stats(items, blocks, transpose: bool, f: int, n_nonzero: int):
    """What one spmm call walks: its work items (those of the output
    blocks `blocks`), the tiles they walk, which must equal the call's
    n_nonzero tiles, and the longest item, at most SCHED_CHUNK; with the
    kernel instance's registers, shared memory and TF32 tensor-core
    instruction count."""
    from repro_torch.kernels import gcn_spmm
    it = items.cpu().numpy()
    b, e = blocks
    sel = (it[..., 0] >= b) & (it[..., 0] < e)
    walked = (it[..., 2] - it[..., 1])[sel]
    fb = gcn_spmm.feature_block(f)
    out = dict(items=int(sel.sum()), tiles_walked=int(walked.sum()),
               nonzero_tiles=n_nonzero, longest_item=int(walked.max()),
               chunk=gcn_spmm.SCHED_CHUNK, fb=fb, slices=-(-f // fb),
               registers=SPMM_BUILD[transpose, fb][0],
               smem_bytes=gcn_spmm.smem_bytes(fb),
               tf32_mma_in_sass=SPMM_BUILD[transpose, fb][1])
    assert out["tiles_walked"] == n_nonzero, out
    assert out["longest_item"] <= gcn_spmm.SCHED_CHUNK, out
    return out


def _bsr_operand(topo, transpose: bool, only=None):
    """Block-diagonal BSR matrix of all partitions' nonzero tiles (P or Pᵀ;
    those of the (P, n) mask `only` over the value array when given), the
    same as dense (P, out, in) shards, and the padded input rows of one
    partition."""
    import torch
    P, n = topo.tile_rows.shape
    nrb = topo.tile_row_ptr.shape[1] - 1
    ncb = topo.tile_col_ptr.shape[1] - 1
    vals = topo.tile_vals
    keep = vals.abs().amax(dim=(-1, -2)) > 0
    if only is not None:
        keep = keep & only
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


def _library_call(topo, transpose: bool, only=None):
    """One PyTorch call that computes the same product (of the tiles in
    `only`, see _bsr_operand) on a padded input: the BSR sparse product
    where it runs for f32 on this card, else the dense batched matmul of
    the densified shards. Returns (name, fn(x_pad), in_rows) where x_pad
    is (P, in_rows, F) with in_rows the padded input rows."""
    import torch
    bsr, dense, in_rows = _bsr_operand(topo, transpose, only)
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


# graph -> the widths its main paths run spmm / spmm_t at: reddit-sim's
# layer inputs and outputs 128, 256, 16; yelp-sim's 120, 512, 24
SPMM_WIDTHS = {"reddit-sim": (128, 256, 16), "yelp-sim": (120, 512, 24)}


def phase_kernels(topos):
    """spmm / spmm_t vs plain versions at every width the main paths run
    them at, on each graph's topology; timings."""
    rows = {}
    for graph, widths in SPMM_WIDTHS.items():
        for name, row in _spmm_rows(topos[graph], graph, widths):
            rows.setdefault(name, []).append(row)
    return rows


def _spmm_rows(topo, graph, widths):
    import torch
    from repro_torch.kernels import gcn_spmm
    P, n = topo.tile_rows.shape
    R = topo.max_inner
    C = R + topo.halo_size
    nrb, ncb = -(-R // 128), -(-C // 128)
    n_nz = int((topo.tile_vals.abs().amax(dim=(-1, -2)) > 0).sum())
    gen = torch.Generator(device="cuda").manual_seed(0)
    libs = {False: _library_call(topo, False), True: _library_call(topo, True)}
    # the schedules that walk every stream slot, the zero padding and
    # filler tiles too, as the Pallas grid does
    full = topo.with_schedules(walk_all=True)
    for f in widths:
        h = torch.randn(P, C, f, device="cuda", generator=gen)
        dz = torch.randn(P, R, f, device="cuda", generator=gen)
        fwd = (lambda h=h, s=(topo.tile_work, topo.tile_items): gcn_spmm.spmm(
            *s, topo.tile_rows, topo.tile_cols, topo.tile_vals, h, R))
        fwd_plain = (lambda h=h: gcn_spmm.spmm_plain(
            topo.tile_rows, topo.tile_cols, topo.tile_vals, h, R))
        bwd = (lambda dz=dz, s=(topo.tile_t_work, topo.tile_t_items):
               gcn_spmm.spmm_t(*s, topo.tile_t_out, topo.tile_t_in,
                               topo.tile_t_perm, topo.tile_vals, dz, C))
        bwd_plain = (lambda dz=dz: gcn_spmm.spmm_t_plain(
            topo.tile_t_out, topo.tile_t_in, topo.tile_t_perm,
            topo.tile_vals, dz, C))
        fwd_full = (lambda h=h, s=(full.tile_work, full.tile_items):
                    gcn_spmm.spmm(*s, topo.tile_rows, topo.tile_cols,
                                  topo.tile_vals, h, R))
        bwd_full = (lambda dz=dz, s=(full.tile_t_work, full.tile_t_items):
                    gcn_spmm.spmm_t(*s, topo.tile_t_out, topo.tile_t_in,
                                    topo.tile_t_perm, topo.tile_vals, dz, C))
        for name, kern, kern_full, plain, x, in_rows, out_rows, tr in (
                ("spmm", fwd, fwd_full, fwd_plain, h, C, R, False),
                ("spmm_t", bwd, bwd_full, bwd_plain, dz, R, C, True)):
            got, want = kern(), plain()
            torch.cuda.synchronize()
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
            assert torch.equal(kern_full(), got)
            # A/B in turns (nonzero, all slots, all slots, nonzero)
            ab = [cuda_time_ms(k, 20) for k in (kern, kern_full, kern_full, kern)]
            err = float((got - want).abs().max())
            lib_name, lib_fn, in_pad = libs[tr]
            lib_in = _pad_rows(x, in_pad)
            lib_out = lib_fn(lib_in).reshape(P, -1, f)[:, :out_rows]
            lib_err = float((lib_out - want).abs().max())
            flops = 2.0 * n_nz * 128 * 128 * f
            nbytes = (n_nz * 128 * 128 * 4 + P * in_rows * f * 4
                      + P * out_rows * f * 4)
            items = topo.tile_t_items if tr else topo.tile_items
            sched = schedule_stats(items, (0, ncb if tr else nrb), tr, f, n_nz)
            row = dict(graph=graph, f=f, max_abs_err=err,
                       ms=(ab[0] + ab[3]) / 2,
                       ms_full_stream=(ab[1] + ab[2]) / 2, ab_ms=ab,
                       plain_ms=cuda_time_ms(plain, 5),
                       library=lib_name,
                       library_ms=cuda_time_ms(lambda: lib_fn(lib_in), 10),
                       library_max_abs_err=lib_err, schedule=sched,
                       **gcn_bound(flops, nbytes))
            log(f"kernels: {name} {graph} F={f} max_abs_err {err:.3g} "
                f"kernel {row['ms']:.4f} ms (every slot "
                f"{row['ms_full_stream']:.4f} ms, bit-equal) plain "
                f"{row['plain_ms']:.4f} ms {lib_name} {row['library_ms']:.4f} "
                f"ms bound {row['bound_ms']:.4f} ms ({row['bound_by']}; f32 "
                f"FMA {row['bound_fma_ms']:.4f}); {json.dumps(sched)}")
            yield name, row
    log(f"kernels: {graph} {n_nz} nonzero 128x128 tiles over {P} partitions "
        f"({n} stream slots each)")


def _pad_rows(x, rows: int):
    """(P, r, F) -> (P, rows, F), zero-padded to the tile grid."""
    import torch
    pad = rows - x.shape[1]
    return torch.cat([x, x.new_zeros(x.shape[0], pad, x.shape[2])], 1) if pad else x


def _timed_pair(kern, other, reps: int = 20):
    """Mean device ms of kern and other, timed in turns (k, o, o, k)."""
    t = [cuda_time_ms(f, reps) for f in (kern, other, other, kern)]
    return (t[0] + t[3]) / 2, (t[1] + t[2]) / 2


def phase_fused_kernels(topos):
    """The fused pair vs plain versions and the composed path, at the
    reddit-sim and yelp-sim shapes of the fused main paths."""
    import torch
    from repro_torch.kernels import gcn_spmm
    from repro_torch.kernels.aggregate import get_engine
    composed = get_engine("blocksparse")     # spmm kernel + torch.matmul
    gen = torch.Generator(device="cuda").manual_seed(1)
    # (graph, F_in, F_out, with_z, relu): every shape the fused runs of
    # phases "steps" and "train" launch spmm_fused at (the GCN eval forward
    # of phase "steps" at 128->256 and 256->256 with the ReLU epilogue)
    fwd_cases = [("reddit-sim", 128, 256, True, False),
                 ("reddit-sim", 128, 256, False, False),
                 ("reddit-sim", 128, 256, False, True),
                 ("reddit-sim", 256, 256, True, False),
                 ("reddit-sim", 256, 256, False, False),
                 ("reddit-sim", 256, 256, False, True),
                 ("reddit-sim", 256, 16, True, False),
                 ("reddit-sim", 256, 16, False, False),
                 ("yelp-sim", 120, 512, True, False),
                 ("yelp-sim", 120, 512, False, False),
                 ("yelp-sim", 512, 512, False, False)]
    bwd_cases = [("reddit-sim", 256, 256), ("reddit-sim", 256, 16),
                 ("reddit-sim", 16, 256), ("yelp-sim", 512, 512)]
    rows = {"spmm_fused": [], "spmm_fused_t": []}

    def shapes(name):
        topo = topos[name]
        fields = tuple(getattr(topo, f) for f in composed.fields)
        n_nz = int((topo.tile_vals.abs().amax(dim=(-1, -2)) > 0).sum())
        return (topo, fields, topo.tile_rows.shape[0], topo.max_inner,
                topo.max_inner + topo.halo_size, n_nz)

    def record(kernel, row, flops, nbytes):
        row.update(gcn_bound(flops, nbytes))
        rows[kernel].append(row)
        log(f"kernels: {kernel} {row['graph']} F_in {row['fin']} F_out "
            f"{row['fout']}{' z' if row.get('with_z') else ''}"
            f"{' relu' if row.get('relu') else ''} max_abs_err "
            f"{row['max_abs_err']:.3g} kernel {row['ms']:.4f} ms composed "
            f"{row['composed_ms']:.4f} ms plain {row['plain_ms']:.4f} ms "
            f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}; f32 FMA "
            f"{row['bound_fma_ms']:.4f})")

    for name, fin, fout, with_z, relu in fwd_cases:
        topo, fields, P, R, C, n_nz = shapes(name)
        h = torch.randn(P, C, fin, device="cuda", generator=gen)
        w = torch.randn(fin, fout, device="cuda", generator=gen) / fin ** 0.5
        b = 0.1 * torch.randn(fout, device="cuda", generator=gen)
        args = (topo.tile_row_ptr, topo.tile_live, topo.tile_rows,
                topo.tile_cols, topo.tile_vals, h, w, b, R)
        kern = (lambda a=args, z=with_z, r=relu:
                gcn_spmm.spmm_fused(*a, relu=r, with_z=z))
        plain = (lambda a=args, z=with_z, r=relu:
                 gcn_spmm.spmm_fused_plain(*a[2:], relu=r, with_z=z))
        comp = (lambda f=fields, h=h, w=w, b=b, z=with_z, r=relu:
                composed.aggregate_transform(f, h, w, b, R, relu=r, with_z=z))
        (u, z), (pu, pz) = kern(), plain()
        torch.cuda.synchronize()
        err = gcn_spmm.assert_close_to_scale(
            u, pu, f"spmm_fused {name} {fin}->{fout}")
        if with_z:
            err = max(err, gcn_spmm.assert_close_to_scale(
                z, pz, f"spmm_fused z {name} {fin}->{fout}"))
        ms, composed_ms = _timed_pair(kern, comp)
        flops = 2.0 * n_nz * 128 * 128 * fin + 2.0 * P * R * fin * fout
        nbytes = 4.0 * (n_nz * 128 * 128 + P * C * fin + fin * fout + fout
                        + P * R * fout + (P * R * fin if with_z else 0))
        record("spmm_fused", dict(
            graph=name, fin=fin, fout=fout, with_z=with_z, relu=relu,
            max_abs_err=err, ms=ms, composed_ms=composed_ms,
            plain_ms=cuda_time_ms(plain, 5)), flops, nbytes)
    for name, fin, fout in bwd_cases:
        topo, fields, P, R, C, n_nz = shapes(name)
        du = torch.randn(P, R, fout, device="cuda", generator=gen)
        w = torch.randn(fin, fout, device="cuda", generator=gen) / fout ** 0.5
        args = (topo.tile_col_ptr, topo.tile_t_live, topo.tile_t_out,
                topo.tile_t_in, topo.tile_t_perm, topo.tile_vals, du, w, C)
        kern = lambda a=args: gcn_spmm.spmm_fused_t(*a)        # noqa: E731
        plain = lambda a=args: gcn_spmm.spmm_fused_t_plain(*a[2:])  # noqa: E731
        comp = (lambda f=fields, du=du, w=w:
                composed.aggregate_transform_t(f, du, w, C))
        got, want = kern(), plain()
        torch.cuda.synchronize()
        err = gcn_spmm.assert_close_to_scale(
            got, want, f"spmm_fused_t {name} {fin}<-{fout}")
        ms, composed_ms = _timed_pair(kern, comp)
        # the dense product du @ wᵀ counted once per row, as the composed
        # path does it (the kernel's per-slot prologue is its own cost)
        flops = 2.0 * n_nz * 128 * 128 * fin + 2.0 * P * R * fin * fout
        nbytes = 4.0 * (n_nz * 128 * 128 + P * R * fout + fin * fout
                        + P * C * fin)
        record("spmm_fused_t", dict(
            graph=name, fin=fin, fout=fout, max_abs_err=err, ms=ms,
            composed_ms=composed_ms, plain_ms=cuda_time_ms(plain, 5)),
            flops, nbytes)
    return rows


def _rel_close(a, b, what, rel=1e-3):
    """||a - b|| / ||b|| <= rel (Frobenius); returns the ratio."""
    import torch
    assert torch.isfinite(a).all(), f"{what}: non-finite values"
    scale = float(torch.linalg.vector_norm(b.double()))
    diff = float(torch.linalg.vector_norm((a - b).double()))
    assert diff <= rel * scale, \
        f"{what}: ||diff|| {diff:.3g} > {rel} x ||ref|| {scale:.3g}"
    return diff / scale if scale else 0.0


def _float64(data):
    """ShardedData with its float fields in float64."""
    import torch
    return data._replace(**{k: v.to(torch.float64)
                            for k, v in data._asdict().items()
                            if v.is_floating_point()})


# Bound of phase "steps": the kernel path (f32, deterministic) against the
# COO engine in float64, in relative norm per leaf. On an H100 it reads
# 2.16e-4 (reddit-sim) and 2.28e-4 (yelp-sim), the same in every run; the
# COO engine in f32, whose atomic scatter order flips its own ReLUs,
# reads from 4.5e-4 to 9.4e-4 on yelp-sim against the same reference.
STEP_REL = 5e-4


def _leaf_diffs(run, ref, what, rel):
    """Relative norm diffs of a run's (loss, grads, buffers) against the
    reference's, each checked against `rel`."""
    (lk, gk, bk), (lp, gp, bp) = run, ref
    diffs = [_rel_close(lk.reshape(1), lp.reshape(1), f"{what} loss", rel)]
    diffs += [_rel_close(gk[k], gp[k], f"{what} grad {k}", rel) for k in gp]
    for kind in ("feat", "grad"):
        diffs += [_rel_close(a, b, f"{what} {kind}[{ell}]", rel)
                  for ell, (a, b) in enumerate(zip(bk[kind], bp[kind]))]
    return diffs


def phase_steps(reddit, yelp):
    """2 training steps through the kernels (f32) vs 2 through the COO
    engine in float64 on the card, each at its dataset's full-width model
    with dropout 0: reddit-sim for each tile engine and order, yelp-sim
    for the fused engine under auto; then a GCN eval forward through the
    fused kernels (their in-kernel ReLU) vs the COO engine in float64. The
    f64 reference carries no rounding of its own, so STEP_REL bounds the
    f32 kernel path alone. The COO engine in f32 runs beside it, and its
    reading against the same reference is printed: an f32 reference adds
    its own ReLU flips to the kernels'."""
    import dataclasses
    import torch
    from repro_torch.core import PipeConfig, PipeGCN
    worst = 0.0

    def config(pipeline, agg, order, **kw):
        mc, _ = _model_config(pipeline, agg, order)
        return dataclasses.replace(mc, dropout=0.0, **kw)

    for pipeline, agg, order in ((reddit, "blocksparse", "auto"),
                                 (reddit, "fused", "aggregate-first"),
                                 (reddit, "fused", "auto"),
                                 (yelp, "fused", "auto")):
        ds = pipeline.dataset
        models = {a: PipeGCN(config(pipeline, a, order),
                             PipeConfig.named("pipegcn"))
                  for a in (agg, "coo")}
        params0 = models["coo"].init_params(
            torch.Generator(device="cuda").manual_seed(0))
        runs = {"kernels": (models[agg], pipeline.topo, pipeline.train_data),
                "coo-f32": (models["coo"], pipeline.topo,
                            pipeline.train_data),
                "coo-f64": (models["coo"], pipeline.topo.to(torch.float64),
                            _float64(pipeline.train_data))}
        state = {r: ({k: v.to(data.x.dtype) for k, v in params0.items()},
                     m.init_buffers(topo, dtype=data.x.dtype))
                 for r, (m, topo, data) in runs.items()}
        diffs, ref_diffs = [], []
        for t in range(2):
            out = {}
            for r, (m, topo, data) in runs.items():
                params, bufs = state[r]
                loss, grads, bufs, logits = m.train_step(topo, params, bufs,
                                                         data)
                out[r] = (loss, grads, bufs, logits)
                state[r] = ({k: params[k] - 0.01 * grads[k] for k in params},
                            bufs)
            zk, zp = out["kernels"][3], out["coo-f64"][3]
            assert zk.shape == (4, pipeline.topo.max_inner, ds.num_classes)
            assert zk.dtype == torch.float32 and zp.dtype == torch.float64
            what = f"{ds.name} {agg}/{order} step {t}"
            step = _leaf_diffs(out["kernels"][:3], out["coo-f64"][:3], what,
                               STEP_REL)
            ref = _leaf_diffs(out["coo-f32"][:3], out["coo-f64"][:3],
                              f"{what} coo-f32", rel=1e-2)
            diffs += step
            ref_diffs += ref
            log(f"steps: {what} loss kernels {float(out['kernels'][0]):.6f} "
                f"coo-f32 {float(out['coo-f32'][0]):.6f} coo-f64 "
                f"{float(out['coo-f64'][0]):.6f}; worst leaf vs coo-f64: "
                f"kernels {max(step):.3g}, coo-f32 {max(ref):.3g}")
        log(f"steps: {ds.name} {agg}/{order} worst relative norm diff "
            f"{max(diffs):.3g} (coo-f32 vs coo-f64 {max(ref_diffs):.3g})")
        worst = max(worst, *diffs)
    gcn = {a: PipeGCN(config(reddit, a, "aggregate-first", kind="gcn"),
                      PipeConfig())
           for a in ("fused", "coo")}
    params = gcn["coo"].init_params(
        torch.Generator(device="cuda").manual_seed(0))
    logits = {
        "fused": gcn["fused"].forward(reddit.topo, params,
                                      reddit.val_data)[1],
        "coo": gcn["coo"].forward(
            reddit.topo.to(torch.float64),
            {k: v.double() for k, v in params.items()},
            _float64(reddit.val_data))[1]}
    worst = max(worst, _rel_close(logits["fused"], logits["coo"],
                                  "gcn eval forward logits", STEP_REL))
    log(f"steps: loss, grads and buffers agree (worst relative norm diff "
        f"{worst:.3g} <= {STEP_REL})")
    return worst


KERNELS = ("spmm", "spmm_t", "spmm_fused", "spmm_fused_t", "spmm_phased",
           "spmm_t_phased", "flash_attention")


def kernel_wrappers() -> dict:
    """kernel name -> its wrapper, whose `launches` attribute counts the
    wrapper's kernel launches."""
    from repro_torch.kernels import flash_attention, gcn_spmm
    out = {k: getattr(gcn_spmm, k) for k in KERNELS if k != "flash_attention"}
    out["flash_attention"] = flash_attention.flash_attention
    return out


def reset_launches():
    for wrapper in kernel_wrappers().values():
        wrapper.launches = 0


def read_launches() -> dict:
    return {k: w.launches for k, w in kernel_wrappers().items()}


def expected_launches(model, topo, steps: int, evals: int) -> dict:
    """Kernel launches a run of `steps` train steps and `evals` eval
    forwards implies, from its layer orders. Unsplit: a transform-first
    layer runs spmm forward and spmm_t backward (layer 0 too: its weight
    gradient needs Pᵀ·du); an aggregate-first layer runs spmm_fused (fused
    engine) or spmm (blocksparse) forward, and spmm_fused_t or spmm_t
    backward except at layer 0, where Alg. 1 stops the backward. Split:
    every layer runs spmm_phased twice (boundary, interior) forward and
    spmm_t_phased twice backward from layer 1 on, layer 0 the unphased
    spmm_t where it is transform-first; the eval forward (vanilla, "auto"
    overlap) splits likewise."""
    import dataclasses
    from repro_torch.core import PipeConfig
    fused = model.model.agg == "fused"
    n = dict.fromkeys(KERNELS, 0)
    split = model._split_active() is not None
    for ell, order in enumerate(model.step_orders(topo, train=True)):
        tf = order == "transform-first"
        if split:
            n["spmm_phased"] += 2 * steps
            if ell > 0:
                n["spmm_t_phased"] += 2 * steps
            elif tf:
                n["spmm_t"] += steps
            continue
        n["spmm" if tf or not fused else "spmm_fused"] += steps
        if tf or ell > 0:
            n["spmm_t" if tf or not fused else "spmm_fused_t"] += steps
    evaluator = dataclasses.replace(model, pipe=PipeConfig.vanilla())
    split = evaluator._split_active() is not None
    for order in evaluator.step_orders(topo, train=False):
        tf = order == "transform-first"
        if split:
            n["spmm_phased"] += 2 * evals
        else:
            n["spmm" if tf or not fused else "spmm_fused"] += evals
    return n


def _model_config(pipeline, agg, order):
    """The dataset's published model (graph/synthetic.py templates) at
    full width, GraphSAGE."""
    from repro_torch.core import ModelConfig
    from repro_torch.graph.synthetic import model_template
    ds = pipeline.dataset
    tpl = model_template(ds.name)
    return ModelConfig(kind="sage", feat_dim=ds.feat_dim, hidden=tpl["hidden"],
                       num_layers=tpl["num_layers"],
                       num_classes=ds.num_classes, dropout=tpl["dropout"],
                       multilabel=ds.multilabel, agg=agg, matmul_order=order,
                       layout=pipeline.layout), tpl["lr"]


def graph_name(pipeline) -> str:
    """The graph and its partition count, e.g. "yelp-sim P=2"."""
    return f"{pipeline.dataset.name} P={pipeline.topo.num_parts}"


def train_run(pipeline, agg, order):
    """One main path: train_pipegcn for EPOCHS epochs, with every launch
    count zeroed just before and read just after; the counts must equal
    expected_launches."""
    from repro_torch.core import PipeConfig, PipeGCN, train_pipegcn
    from repro_torch.core.pipegcn import SimBackend
    from repro_torch.core.trace_utils import expected_boundary_collectives
    name = graph_name(pipeline)
    mc, lr = _model_config(pipeline, agg, order)
    reset_launches()
    SimBackend.side_copies = 0
    res = train_pipegcn(pipeline, mc, PipeConfig.named("pipegcn"),
                        epochs=EPOCHS, lr=lr, seed=0, eval_every=EVAL_EVERY,
                        log=lambda s: log(f"train {name} {agg}/{order}: {s}"),
                        device="cuda")
    launches = read_launches()
    copies = SimBackend.side_copies
    model = PipeGCN(mc, PipeConfig.named("pipegcn"),
                    split=pipeline.split_spec())
    n_eval = len(res.history["epoch"])
    expect = expected_launches(model, pipeline.topo, EPOCHS, n_eval)
    assert all(math.isfinite(v) for v in res.history["loss"]), res.history
    assert launches == expect, (name, agg, order, launches, expect)
    # the split starts every exchange on the side stream: 2 per fused
    # train step, L per (vanilla) eval forward; the unsplit step none
    L = mc.num_layers
    want = (EPOCHS * expected_boundary_collectives(L, True) + n_eval * L
            if model._split_active() is not None else 0)
    assert copies == want, (name, agg, order, copies, want)
    launches["side_stream_copies"] = copies
    log(f"train {name} {agg}/{order}: loss {res.history['loss'][-1]:.4f} "
        f"val {res.final_metrics['val']:.4f} epochs/s "
        f"{res.epochs_per_sec:.3f} launches {launches} ({EPOCHS} steps, "
        f"{n_eval} evals)")
    return dict(graph=name, agg=agg, order=order,
                orders_train=model.step_orders(pipeline.topo, train=True),
                orders_eval=model.layer_orders(pipeline.topo, train=False),
                loss=res.history["loss"][-1], val=res.final_metrics["val"],
                epochs_per_sec=res.epochs_per_sec, launches=launches,
                steps=EPOCHS, evals=n_eval)


def phase_train(reddit, yelp, split_pipes):
    """The main paths of every slice, each with its own launch counts: the
    unsplit reddit-sim and yelp-sim P=4 runs, and the split runs on the
    graphs where a split exists."""
    runs = {}
    mc, _ = _model_config(reddit, "blocksparse", "auto")
    assert (mc.feat_dim, mc.hidden, mc.num_layers, mc.num_classes,
            mc.dropout) == (128, 256, 4, 16, 0.5)
    mc, _ = _model_config(yelp, "fused", "auto")
    assert (mc.feat_dim, mc.hidden, mc.num_layers, mc.num_classes,
            mc.dropout, mc.multilabel) == (120, 512, 4, 24, 0.1, True)
    yelp2, grid = split_pipes
    mc, _ = _model_config(grid, "blocksparse", "auto")
    assert (mc.feat_dim, mc.hidden, mc.num_layers, mc.num_classes,
            mc.dropout) == (32, 64, 3, 4, 0.2)
    for pipeline, agg, order in ((reddit, "blocksparse", "auto"),
                                 (reddit, "fused", "auto"),
                                 (reddit, "fused", "aggregate-first"),
                                 (yelp, "fused", "auto"),
                                 (yelp2, "blocksparse", "auto"),
                                 (yelp2, "fused", "auto"),
                                 (grid, "blocksparse", "auto")):
        runs[graph_name(pipeline), agg, order] = train_run(pipeline, agg,
                                                           order)
    for key in runs:
        split = key[0] in {graph_name(p) for p in split_pipes}
        phased = runs[key]["launches"]["spmm_phased"]
        assert (phased > 0) == split, (key, runs[key]["launches"])
    # reddit-sim under auto: pricing the fused kernels moves training
    # layers 1-2 to transform-first, so a step runs 1 spmm_fused + 3 spmm
    # + 3 spmm_t and an eval 3 spmm_fused + 1 spmm
    a, t = "aggregate-first", "transform-first"
    r = runs["reddit-sim P=4", "fused", "auto"]
    assert r["orders_train"] == (a, t, t, t), r["orders_train"]
    assert r["orders_eval"] == (a, a, a, t), r["orders_eval"]
    return runs


def _timed_steps(step, state, n: int) -> list[float]:
    """Host ms of n train steps, each ended by a device sync; `state` is
    the (topo, params, opt_state, buffers, data, generator) list, updated
    in place."""
    import torch
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        out = step(*state)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        state[1:4] = out[1:4]
    return times


def phase_step_times(reddit, yelp):
    """Median train-step ms of blocksparse vs fused (auto order) on each
    graph, 2 warm-up steps, then 10 steps each in turns (bs, f, f, bs)."""
    import torch
    from repro_torch.core import HealthConfig, PipeConfig, PipeGCN, make_train_step
    from repro_torch.optim import adam
    out = {}
    for pipeline in (reddit, yelp):
        state = {}
        for agg in ("blocksparse", "fused"):
            mc, lr = _model_config(pipeline, agg, "auto")
            model = PipeGCN(mc, PipeConfig.named("pipegcn"))
            opt = adam(lr)
            params = model.init_params(
                torch.Generator(device="cuda").manual_seed(0))
            state[agg] = (make_train_step(model, opt, HealthConfig()), [
                pipeline.topo, params, opt.init(params),
                model.init_buffers(pipeline.topo), pipeline.train_data,
                torch.Generator(device="cuda").manual_seed(1)])
            _timed_steps(*state[agg], 2)
        times = {"blocksparse": [], "fused": []}
        for agg in ("blocksparse", "fused", "fused", "blocksparse"):
            times[agg] += _timed_steps(*state[agg], 10)
        name = pipeline.dataset.name
        out[name] = {}
        for agg, ts in times.items():
            q = sorted(ts)
            out[name][agg] = dict(median=(q[9] + q[10]) / 2, q1=q[4],
                                  q3=q[14], max=q[-1])
            log(f"step: {name} {agg} train step ms over {len(q)} steps: "
                f"median {out[name][agg]['median']:.3f} quartiles "
                f"{q[4]:.3f} {q[14]:.3f} max {q[-1]:.3f}")
    log("step: " + json.dumps(out))
    return out


def phase_profile(pipeline, agg):
    """Optional: torch.profiler table of two training steps with engine
    `agg`, written under chiprun_out/; prints the device time per kernel
    name."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import HealthConfig, PipeConfig, PipeGCN, make_train_step
    from repro_torch.optim import adam
    mc, lr = _model_config(pipeline, agg, "auto")
    model = PipeGCN(mc, PipeConfig.named("pipegcn"))
    params = model.init_params(torch.Generator(device="cuda").manual_seed(0))
    opt = adam(lr)
    step = make_train_step(model, opt, HealthConfig())
    state = [pipeline.topo, params, opt.init(params),
             model.init_buffers(pipeline.topo), pipeline.train_data,
             torch.Generator(device="cuda").manual_seed(1)]
    _timed_steps(step, state, 2)     # warm-up
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _timed_steps(step, state, 2)
    wall = time.perf_counter() - t0
    table = prof.key_averages().table(sort_by="cuda_time_total", row_limit=40)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", f"profile_step_{agg}.txt"),
              "w") as f:
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
    log(f"profile {agg}: " + json.dumps({
        "steps": 2, "wall_ms_profiled": wall * 1e3,
        "device_busy_ms": total / 1e3,
        "top": [[e.key[:60], dev_us(e) / 1e3, e.count] for e in top]}))


ATTENTION_RUN = ("attention layers", "ops.attention", "flash")   # run key

# kernel -> (the TPU kernel it replaces, its CUDA source, the main-path run
# whose launch count it reports, the shape its times are given at)
KERNEL_INFO = {
    "spmm": ("src/repro/kernels/gcn_spmm.py:110", "gcn_spmm.cu",
             ("reddit-sim P=4", "blocksparse", "auto"),
             dict(graph="reddit-sim", f=256)),
    "spmm_t": ("src/repro/kernels/gcn_spmm.py:182", "gcn_spmm.cu",
               ("reddit-sim P=4", "blocksparse", "auto"),
               dict(graph="reddit-sim", f=256)),
    "spmm_fused": ("src/repro/kernels/gcn_spmm.py:370", "gcn_fused.cu",
                   ("reddit-sim P=4", "fused", "auto"),
                   dict(graph="reddit-sim", fin=128, fout=256)),
    "spmm_fused_t": ("src/repro/kernels/gcn_spmm.py:458", "gcn_fused.cu",
                     ("reddit-sim P=4", "fused", "aggregate-first"),
                     dict(graph="reddit-sim", fin=256, fout=256)),
    "spmm_phased": ("src/repro/kernels/gcn_spmm.py:245", "gcn_spmm.cu",
                    ("yelp-sim P=2", "blocksparse", "auto"),
                    dict(graph="yelp-sim P=2", f=512)),
    "spmm_t_phased": ("src/repro/kernels/gcn_spmm.py:267", "gcn_spmm.cu",
                      ("yelp-sim P=2", "blocksparse", "auto"),
                      dict(graph="yelp-sim P=2", f=512)),
    "flash_attention": ("src/repro/kernels/flash_attention.py:72",
                        "flash_attention.cu", ATTENTION_RUN,
                        dict(arch="qwen3-8b", s=8192, causal=True,
                             dtype="float32")),
}


def kernel_entry(name, rows, runs) -> dict:
    """One entry of the {"kernels": [...]} line: times at the main path's
    shape, the worst error over all shapes, launches from its main-path
    run (and, under launches_by_run, from every run)."""
    replaces, source, run, at = KERNEL_INFO[name]
    assert runs[run]["launches"][name] > 0, (name, run, runs[run]["launches"])
    main_row = next(r for r in rows if all(r[k] == v for k, v in at.items()))
    err = max(r["max_abs_err"] for r in rows)
    entry = dict(name=name, route="cuda",
                 source="src/repro_torch/kernels/csrc/" + source,
                 replaces=replaces, launches=runs[run]["launches"][name],
                 max_abs_err=err, ms=main_row["ms"],
                 plain_ms=main_row["plain_ms"], bound_ms=main_row["bound_ms"],
                 bound_by=main_row["bound_by"],
                 library_ms=main_row.get("library_ms"), at=at,
                 launches_by_run={"/".join(k): r["launches"][name]
                                  for k, r in runs.items()},
                 per_shape=rows)
    if "library" in main_row:
        entry["library"] = main_row["library"]
    else:   # no single PyTorch call computes the fused function
        entry["composed_ms"] = main_row["composed_ms"]
    if "bound_fma_ms" in main_row:   # the GCN kernels: the f32-FMA bound
        entry["bound_fma_ms"] = main_row["bound_fma_ms"]
    for k in ("boundary_ms", "interior_ms", "unsplit_ms"):   # phased pair
        if k in main_row:
            entry[k] = main_row[k]
    return entry


# ---------------------------------------------------------------------
# The split-phase slice: phased kernels, split steps, the NCCL backend,
# step times and the overlap on the card
# ---------------------------------------------------------------------

SPLIT_GRAPHS = (("yelp-sim", 2), ("grid-sim", 4))   # where a split exists


def split_model(pipeline, agg, overlap="auto", dropout=None, **pipe_kw):
    """The graph's published model (full width), split spec attached."""
    import dataclasses
    from repro_torch.core import PipeConfig, PipeGCN
    mc, lr = _model_config(pipeline, agg, "auto")
    if dropout is not None:
        mc = dataclasses.replace(mc, dropout=dropout)
    pc = dataclasses.replace(PipeConfig.named("pipegcn"), overlap=overlap,
                             **pipe_kw)
    return PipeGCN(mc, pc, split=pipeline.split_spec()), lr


def phased_widths(model, topo) -> dict:
    """kernel -> the widths the split main path launches it at: forward
    phases at F_in (aggregate-first) or F_out (transform-first) of every
    layer, in training and at eval; transpose phases likewise from layer 1
    on."""
    import dataclasses
    from repro_torch.core import PipeConfig
    dims = model.model.layer_dims()
    evaluator = dataclasses.replace(model, pipe=PipeConfig.vanilla())
    out = {"spmm_phased": set(), "spmm_t_phased": set()}
    for m, train in ((model, True), (evaluator, False)):
        for ell, o in enumerate(m.step_orders(topo, train=train)):
            f = dims[ell][0] if o == "aggregate-first" else dims[ell][1]
            out["spmm_phased"].add(f)
            if train and ell > 0:
                out["spmm_t_phased"].add(f)
    return {k: sorted(v) for k, v in out.items()}


def _phase_stats(topo, slots, in_idx, transpose):
    """Nonzero tiles of a phase (stream slots `slots`) and the distinct
    input blocks they read, summed over partitions."""
    import torch
    vals = topo.tile_vals
    nz = vals.abs().amax(dim=(-1, -2)) > 0          # (P, n) by vals index
    if transpose:
        nz = torch.gather(nz, 1, topo.tile_t_perm.long())
    nz = nz[:, slots]
    idx = in_idx[:, slots]
    n_in = sum(len(set(idx[p][nz[p]].tolist())) for p in range(nz.shape[0]))
    return int(nz.sum()), n_in


def phase_phased_kernels(split_pipes):
    """spmm_phased / spmm_t_phased vs their plain versions at every width
    the split main paths launch them at, both phases: in-phase rows within
    rtol = atol = 1e-5, every in-phase row written (the output is NaN
    before the launch) and no other row (still NaN after it), boundary +
    interior reassembled bit-equal to the unsplit kernel. Times: each
    phase, the unsplit kernel on all the blocks, the plain phased pair,
    and the BSR library product of each phase's tiles."""
    import torch
    from repro_torch.kernels import gcn_spmm
    rows = {"spmm_phased": [], "spmm_t_phased": []}
    gen = torch.Generator(device="cuda").manual_seed(2)
    for pipeline in split_pipes:
        topo, sp = pipeline.topo, pipeline.split_spec()
        model, _ = split_model(pipeline, "blocksparse")
        widths = phased_widths(model, topo)
        P, n = topo.tile_rows.shape
        R, C = topo.max_inner, topo.max_inner + topo.halo_size
        fwd = (topo.tile_work, topo.tile_items, topo.tile_rows,
               topo.tile_cols, topo.tile_vals)
        bwd = (topo.tile_t_work, topo.tile_t_items, topo.tile_t_out,
               topo.tile_t_in, topo.tile_t_perm, topo.tile_vals)
        libs = {tr: {ph: _library_call(topo, tr, _phase_keep(topo, sp, tr, ph))
                     for ph in ("boundary", "interior")}
                for tr in (False, True)}
        for kernel, transpose, f_list in (
                ("spmm_phased", False, widths["spmm_phased"]),
                ("spmm_t_phased", True, widths["spmm_t_phased"])):
            tail = sp.col_tail if transpose else sp.row_tail
            out_rows, in_rows = (C, R) if transpose else (R, C)
            n_bnd = sp.t_bnd_tiles if transpose else sp.fwd_bnd_tiles
            for f in f_list:
                x = torch.randn(P, in_rows, f, device="cuda", generator=gen)
                if transpose:
                    def run(ph, out=None, x=x):
                        return gcn_spmm.spmm_t_phased(*bwd, x, C, sp, ph,
                                                      out=out)

                    def plain(ph, x=x):
                        return gcn_spmm.spmm_t_phased_plain(
                            *bwd[2:], x, C, sp, ph)
                    full = lambda x=x: gcn_spmm.spmm_t(*bwd, x, C)  # noqa: E731
                else:
                    def run(ph, out=None, x=x):
                        return gcn_spmm.spmm_phased(*fwd, x, R, sp, ph,
                                                    out=out)

                    def plain(ph, x=x):
                        return gcn_spmm.spmm_phased_plain(
                            *fwd[2:], x, R, sp, ph)
                    full = lambda x=x: gcn_spmm.spmm(*fwd, x, R)  # noqa: E731
                got, err = {}, 0.0
                for ph in ("boundary", "interior"):
                    sel = slice(tail, None) if ph == "boundary" else slice(0, tail)
                    rest = slice(0, tail) if ph == "boundary" else slice(tail, None)
                    out = torch.full((P, out_rows, f), float("nan"),
                                     device="cuda")
                    got[ph] = run(ph, out=out)
                    want = plain(ph)
                    torch.cuda.synchronize()
                    assert got[ph].data_ptr() == out.data_ptr()
                    assert torch.isfinite(got[ph][:, sel]).all(), (kernel, ph, f)
                    assert torch.isnan(got[ph][:, rest]).all(), (kernel, ph, f)
                    torch.testing.assert_close(got[ph][:, sel], want[:, sel],
                                               rtol=1e-5, atol=1e-5)
                    err = max(err, float((got[ph][:, sel] - want[:, sel])
                                         .abs().max()))
                whole = torch.cat([got["interior"][:, :tail],
                                   got["boundary"][:, tail:]], dim=1)
                assert torch.equal(whole, full()), (kernel, f, "reassembly")
                t = [cuda_time_ms(fn, 20) for fn in (
                    lambda: run("boundary"), lambda: run("interior"), full,
                    full, lambda: run("interior"), lambda: run("boundary"))]
                bnd_ms, int_ms = (t[0] + t[5]) / 2, (t[1] + t[4]) / 2
                flops = nbytes = 0.0
                runs = {}
                ptr = (topo.tile_col_ptr if transpose
                       else topo.tile_row_ptr).cpu()
                for ph in ("boundary", "interior"):
                    slots = gcn_spmm.phase_slots(n, n_bnd, ph)
                    in_idx = topo.tile_t_in if transpose else topo.tile_cols
                    n_nz, n_in = _phase_stats(topo, slots, in_idx, transpose)
                    ph_rows = (out_rows - tail) if ph == "boundary" else tail
                    flops += 2.0 * n_nz * 128 * 128 * f
                    nbytes += 4.0 * (n_nz * 128 * 128
                                     + min(n_in * 128, in_rows * P) * f
                                     + P * ph_rows * f)
                    # what the phase's launch walks, beside the longest
                    # run of stream slots and the zero slots it skips
                    lo, hi = gcn_spmm.phase_blocks(tail, out_rows, ph)
                    runs[ph] = dict(
                        schedule_stats(bwd[1] if transpose else fwd[1],
                                       (lo, hi), transpose, f, n_nz),
                        longest_run_slots=int((ptr[:, lo + 1:hi + 1]
                                               - ptr[:, lo:hi]).max()),
                        zero_slots_skipped=(slots.stop - slots.start) * P
                        - n_nz)
                lib_in = _pad_rows(x, libs[transpose]["boundary"][2])
                lib_ms = sum(cuda_time_ms(lambda fn=libs[transpose][ph][1]:
                                          fn(lib_in), 10)
                             for ph in ("boundary", "interior"))
                row = dict(graph=graph_name(pipeline), f=f, max_abs_err=err,
                           ms=bnd_ms + int_ms, boundary_ms=bnd_ms,
                           interior_ms=int_ms, unsplit_ms=(t[2] + t[3]) / 2,
                           plain_ms=cuda_time_ms(
                               lambda: (plain("boundary"), plain("interior")), 5),
                           library=libs[transpose]["boundary"][0],
                           library_ms=lib_ms, runs=runs,
                           **gcn_bound(flops, nbytes))
                rows[kernel].append(row)
                log(f"kernels: {kernel} {row['graph']} F={f} max_abs_err "
                    f"{err:.3g} boundary {bnd_ms:.4f} ms interior "
                    f"{int_ms:.4f} ms (pair {row['ms']:.4f}) unsplit "
                    f"{row['unsplit_ms']:.4f} ms plain {row['plain_ms']:.4f} "
                    f"ms {row['library']} {lib_ms:.4f} ms bound "
                    f"{row['bound_ms']:.4f} ms ({row['bound_by']}; f32 FMA "
                    f"{row['bound_fma_ms']:.4f}); {json.dumps(runs)}; phases "
                    "reassemble bit-equal, "
                    "out-of-phase rows untouched")
    return rows


def _phase_keep(topo, sp, transpose, phase):
    """(P, n) mask over the value array of the tiles a phase contracts."""
    import torch
    from repro_torch.kernels import gcn_spmm
    P, n = topo.tile_rows.shape
    n_bnd = sp.t_bnd_tiles if transpose else sp.fwd_bnd_tiles
    slots = torch.zeros(P, n, dtype=torch.bool, device=topo.tile_rows.device)
    slots[:, gcn_spmm.phase_slots(n, n_bnd, phase)] = True
    if not transpose:
        return slots
    keep = torch.zeros_like(slots)
    keep.scatter_(1, topo.tile_t_perm.long(), slots)
    return keep


def _steps(model, pipeline, n, backend=None, topo=None, data=None):
    """n training steps at dropout 0 from the seed-0 parameters, plain SGD
    between them; returns [(loss, grads, buffers, logits)]."""
    import torch
    topo = pipeline.topo if topo is None else topo
    data = pipeline.train_data if data is None else data
    params = model.init_params(torch.Generator(device="cuda").manual_seed(0))
    bufs = model.init_buffers(topo)
    out = []
    for _ in range(n):
        loss, grads, bufs, logits = model.train_step(
            topo, params, bufs, data, backend=backend)
        out.append((loss, grads, bufs, logits))
        params = {k: params[k] - 0.01 * grads[k] for k in params}
    return out


def _bit_equal(a, b, what):
    """Bitwise equality of two step results (nested tuples/dicts)."""
    import torch
    if isinstance(a, dict):
        for k in a:
            _bit_equal(a[k], b[k], f"{what}/{k}")
    elif isinstance(a, (tuple, list)):
        for i, (x, y) in enumerate(zip(a, b)):
            _bit_equal(x, y, f"{what}[{i}]")
    else:
        assert torch.isfinite(a).all(), f"{what}: non-finite values"
        assert torch.equal(a, b), f"{what}: not bit-equal"


def phase_split(split_pipes):
    """The split step at full width, 2 steps at dropout 0 per graph:
    blocksparse split (overlap auto) bit-equal to blocksparse unsplit
    (overlap none); fused/auto split (the composed phased path) bit-equal
    to the blocksparse split; exact launch counts of each split run."""
    for pipeline in split_pipes:
        name = graph_name(pipeline)
        unsplit, _ = split_model(pipeline, "blocksparse", "none", dropout=0.0)
        ref = _steps(unsplit, pipeline, 2)
        results = {}
        for agg in ("blocksparse", "fused"):
            model, _ = split_model(pipeline, agg, "auto", dropout=0.0)
            assert model._split_active() is not None, (name, agg)
            reset_launches()
            results[agg] = _steps(model, pipeline, 2)
            launches = read_launches()
            expect = expected_launches(model, pipeline.topo, 2, 0)
            assert launches == expect, (name, agg, launches, expect)
            log(f"split: {name} {agg}/auto 2 steps, launches {launches}, "
                f"orders {model.step_orders(pipeline.topo)}")
        _bit_equal(results["blocksparse"], ref, f"{name} split vs unsplit")
        _bit_equal(results["fused"], results["blocksparse"],
                   f"{name} fused/auto split vs blocksparse split")
        log(f"split: {name} blocksparse split == unsplit bitwise, fused/auto "
            f"split == blocksparse split bitwise (loss "
            f"{float(ref[-1][0]):.6f})")


def phase_spmd(pipeline):
    """The torch.distributed backend with NCCL at world size 1, the 4
    partitions of grid-sim co-resident (the hierarchical exchange with
    n_dev = 1), unsplit and split, 2 steps each against the sim backend;
    then train_pipegcn on it against the sim trainer. Fails if NCCL does
    not initialise."""
    import dataclasses
    import socket
    import torch
    import torch.distributed as dist
    from repro_torch.core import PipeConfig, train_pipegcn
    from repro_torch.core.pipegcn import SpmdBackend
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            rank=0, world_size=1,
                            device_id=torch.device("cuda", 0))
    try:
        P = pipeline.topo.num_parts
        worst = 0.0
        for overlap in ("none", "auto"):
            model, lr = split_model(pipeline, "blocksparse", overlap,
                                    dropout=0.0)
            sim = _steps(model, pipeline, 2)
            spmd = _steps(model, pipeline, 2, backend=SpmdBackend(P))
            try:
                _bit_equal(spmd, sim, f"spmd {overlap}")
                how = "bitwise"
            except AssertionError:
                for (a, b) in zip(spmd, sim):
                    for x, y in zip(_leaves(a), _leaves(b)):
                        worst = max(worst, _rel_close(x, y, "spmd", rel=1e-6))
                how = f"within {worst:.3g} relative norm"
            log(f"spmd: NCCL world 1 x {P} partitions, overlap={overlap} "
                f"({'split' if model._split_active() else 'unsplit'}): 2 "
                f"steps equal the sim backend's {how}")
        mc, lr = _model_config(pipeline, "blocksparse", "auto")
        mc = dataclasses.replace(mc, dropout=0.0)   # the SPMD masks differ
        hist = {}
        for ppd in (None, P):
            hist[ppd] = train_pipegcn(
                pipeline, mc, PipeConfig.named("pipegcn"), epochs=3, lr=lr,
                seed=0, eval_every=1, device="cuda",
                parts_per_device=ppd).history
        assert hist[P]["loss"] == hist[None]["loss"], hist
        log(f"spmd: train_pipegcn 3 epochs on NCCL equals the sim trainer "
            f"(losses {hist[P]['loss']})")
    finally:
        dist.destroy_process_group()


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return [tree.reshape(-1)]


def phase_split_step_times(split_pipes):
    """Median train-step ms, unsplit vs split (blocksparse, auto order),
    per graph: 2 warm-up steps each, then 10 each in turns (unsplit,
    split, split, unsplit)."""
    import torch
    from repro_torch.core import HealthConfig, make_train_step
    from repro_torch.optim import adam
    out = {}
    for pipeline in split_pipes:
        state = {}
        for overlap in ("none", "auto"):
            model, lr = split_model(pipeline, "blocksparse", overlap)
            opt = adam(lr)
            params = model.init_params(
                torch.Generator(device="cuda").manual_seed(0))
            state[overlap] = (make_train_step(model, opt, HealthConfig()), [
                pipeline.topo, params, opt.init(params),
                model.init_buffers(pipeline.topo), pipeline.train_data,
                torch.Generator(device="cuda").manual_seed(1)])
            _timed_steps(*state[overlap], 2)
        times = {"none": [], "auto": []}
        for overlap in ("none", "auto", "auto", "none"):
            times[overlap] += _timed_steps(*state[overlap], 10)
        name = graph_name(pipeline)
        out[name] = {}
        for overlap, ts in times.items():
            q = sorted(ts)
            label = "unsplit" if overlap == "none" else "split"
            out[name][label] = dict(median=(q[9] + q[10]) / 2, q1=q[4],
                                    q3=q[14], max=q[-1])
            log(f"step: {name} blocksparse {label} train step ms over "
                f"{len(q)} steps: median {out[name][label]['median']:.3f} "
                f"quartiles {q[4]:.3f} {q[14]:.3f} max {q[-1]:.3f}")
    log("step: split " + json.dumps(out))
    return out


def phase_exchange(split_pipes, runs):
    """The boundary exchange of the split step on the sim backend (the
    counterpart of the TPU's start_boundary_rdma): the packed forward
    payload (P, P, slot, ΣF) of each split graph's full-width model,
    copied transposed on the side stream (start + wait) against the same
    copy on the compute stream; bound = the payload read and written once
    at the memory rate. Launches: the side-stream copies of the graph's
    blocksparse/auto main-path run."""
    import torch
    from repro_torch.core.pipegcn import SimBackend
    gen = torch.Generator(device="cuda").manual_seed(3)
    out = []
    for pipeline in split_pipes:
        topo = pipeline.topo
        model, _ = split_model(pipeline, "blocksparse")
        width = sum(model.payload_widths(topo))
        P = topo.num_parts
        s = torch.randn(P, P, topo.slot, width, device="cuda", generator=gen)
        backend = SimBackend()
        got = backend.start_exchange(s).wait()
        assert torch.equal(got, s.transpose(0, 1)), graph_name(pipeline)
        side_ms, plain_ms = _timed_pair(
            lambda: backend.start_exchange(s).wait(),
            lambda: s.transpose(0, 1).contiguous())
        nbytes = 2.0 * s.numel() * 4
        run = runs[graph_name(pipeline), "blocksparse", "auto"]
        row = dict(graph=graph_name(pipeline), shape=list(s.shape),
                   ms=side_ms, plain_ms=plain_ms,
                   bound_ms=1e3 * nbytes / PEAK_BYTES, bound_by="bytes",
                   mbytes=nbytes / 1e6,
                   launches=run["launches"]["side_stream_copies"])
        out.append(row)
        log("exchange: " + json.dumps(row))
    return out


def phase_overlap(pipeline, steps: int = 3):
    """Profile `steps` split train steps (blocksparse, auto) and read, from
    the device timeline, how much of each exchange copy on the side stream
    ran inside the interior-phase kernel it was issued before (the first
    spmm kernel launched after the copy, by launch correlation id, on the
    compute stream); also the share inside any compute-stream kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import HealthConfig, make_train_step
    from repro_torch.optim import adam
    model, lr = split_model(pipeline, "blocksparse", "auto")
    opt = adam(lr)
    params = model.init_params(torch.Generator(device="cuda").manual_seed(0))
    step = make_train_step(model, opt, HealthConfig())
    state = [pipeline.topo, params, opt.init(params),
             model.init_buffers(pipeline.topo), pipeline.train_data,
             torch.Generator(device="cuda").manual_seed(1)]
    _timed_steps(step, state, 2)     # warm-up
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _timed_steps(step, state, steps)
    traces = os.path.join(ROOT, "build", "traces")
    os.makedirs(traces, exist_ok=True)
    path = os.path.join(traces, f"trace_split_{pipeline.dataset.name}.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kern = [e for e in events if e.get("ph") == "X"
            and e.get("cat") in ("kernel", "gpu_memcpy")]
    spmm = [e for e in kern if "spmm_items_kernel" in e["name"]]
    assert spmm, "the profile shows no spmm kernel on the device"
    main = spmm[0]["args"]["stream"]
    side = [e for e in kern if e["args"].get("stream") != main]
    assert side, "the profile shows no exchange on a side stream"
    phases = sorted((e for e in spmm if e["args"]["stream"] == main),
                    key=lambda e: e["args"]["correlation"])
    busy = [(e["ts"], e["ts"] + e["dur"]) for e in kern
            if e["args"].get("stream") == main]

    def overlap(e, a, b):
        return max(0.0, min(b, e["ts"] + e["dur"]) - max(a, e["ts"]))
    side_us = inside_us = any_us = 0.0
    for c in side:
        interior = next(e for e in phases
                        if e["args"]["correlation"] > c["args"]["correlation"])
        side_us += c["dur"]
        inside_us += overlap(c, interior["ts"],
                             interior["ts"] + interior["dur"])
        any_us += sum(overlap(c, a, b) for a, b in busy)
    res = dict(graph=graph_name(pipeline), steps=steps,
               side_stream_kernels=len(side), side_us=side_us,
               inside_interior_phase_us=inside_us,
               overlap_share=inside_us / side_us,
               inside_any_compute_kernel_share=any_us / side_us,
               side_names=sorted({e["name"][:50] for e in side}))
    log("overlap: " + json.dumps(res))
    return res


# ---------------------------------------------------------------------
# The flash-attention slice: the kernel behind ops.attention, fed by the
# attention layer at the full head widths of three shipped configurations
# ---------------------------------------------------------------------

# (config, S, causal, dtypes): S = 8192 > BLOCKWISE_THRESHOLD, so the
# port's self_attention takes its blockwise path there; S = 4096 (not
# causal) its dense path. The kernel's entry is reported at the first.
ATTENTION_CASES = (("qwen3-8b", 8192, True, ("float32", "bfloat16")),
                   ("starcoder2-3b", 8192, True, ("float32",)),
                   ("recurrentgemma-2b", 8192, True, ("float32",)),
                   ("qwen3-8b", 4096, False, ("float32",)))
PEAK_BF16_FLOPS = 989e12   # H100 SXM bf16 tensor cores, dense (data sheet)
FLASH_ATOL = {"float32": 2e-5, "bfloat16": 5e-2}   # the JAX kernel tests' bars
# bf16 rows against the oracles that round the scores to bf16 (blockwise
# attention and the self_attention layer on it), as the JAX package does
BF16_ORACLE_ROW_REL = 3e-2


def attention_layer_params(cfg, seed: int) -> dict:
    """The layer's parameters from a numpy seed, as numpy arrays: weights
    N(0, 1/fan_in), biases 0.1·N(0, 1), qk-norm scales 1 + 0.1·N(0, 1)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    d, h, k = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
    hd = cfg.resolved_head_dim
    p = {name: rng.standard_normal(shape, dtype=np.float32) / shape[0] ** 0.5
         for name, shape in (("wq", (d, h * hd)), ("wk", (d, k * hd)),
                             ("wv", (d, k * hd)), ("wo", (h * hd, d)))}
    if cfg.qkv_bias:
        for name, n in (("bq", h * hd), ("bk", k * hd), ("bv", k * hd)):
            p[name] = 0.1 * rng.standard_normal(n, dtype=np.float32)
    if cfg.qk_norm:
        for name in ("qnorm", "knorm"):
            p[name] = 1 + 0.1 * rng.standard_normal(hd, dtype=np.float32)
    return p


def attention_qkv(p, cfg, x, positions):
    """The layer's q, k, v: projections (bias, qk-norm) and RoPE."""
    from repro_torch.models.attention import _project_qkv
    from repro_torch.models.layers import apply_rope
    q, k, v = _project_qkv(p, cfg, x, x)
    return (apply_rope(q, positions, cfg.rope_theta),
            apply_rope(k, positions, cfg.rope_theta), v)


def unmasked_pairs(s: int, t: int, causal: bool, window: int) -> int:
    """(query, key) pairs the masks leave, per batch row and head: key c
    is unmasked for query r on [max(0, r-window+1), min(r, t-1)] (no lower
    end without a window, t-1 when not causal)."""
    import numpy as np
    r = np.arange(s, dtype=np.int64)
    hi = np.minimum(r, t - 1) if causal else np.full(s, t - 1)
    lo = np.maximum(0, r - window + 1) if window else np.zeros(s, np.int64)
    return int(np.maximum(0, hi - lo + 1).sum())


def _sdpa(q, k, v, causal: bool, window: int):
    """The library yardstick: scaled_dot_product_attention on the same
    (B, S, H, d) tensors (viewed as (B, H, S, d)), the window as an additive
    mask. In f32 its memory-efficient backend, a flash-style kernel that
    takes f32 and a mask but not GQA, so k and v are repeated to H heads
    outside the timed call; in bf16 the backend it picks, GQA through
    enable_gqa. Never the port's path."""
    import contextlib
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    s, t = q.shape[1], k.shape[1]
    mask = None
    if window:
        r = torch.arange(s, device=q.device)[:, None]
        c = torch.arange(t, device=q.device)[None, :]
        keep = r - c < window
        if causal:
            keep &= c <= r
        mask = torch.zeros(s, t, dtype=q.dtype, device=q.device)
        mask.masked_fill_(~keep, float("-inf"))
    f32 = q.dtype == torch.float32
    if f32:
        g = q.shape[2] // k.shape[2]
        k, v = (x.repeat_interleave(g, dim=2) for x in (k, v))
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

    def run():
        with (sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION) if f32
              else contextlib.nullcontext()):
            return F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, is_causal=causal and not window,
                enable_gqa=not f32).transpose(1, 2)
    return run


def _sdpa_backend(fn) -> str:
    """The device kernel that takes the most time in one call of fn (the
    SDPA backend PyTorch picked), from a profiler trace."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if getattr(e, "device_type", None) == DeviceType.CUDA]
    if not events:
        return "unknown (no device events)"
    top = max(events, key=lambda e: getattr(
        e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0)))
    return top.key[:80]


def phase_attention():
    """The flash kernel behind ops.attention at the full head widths of
    qwen3-8b, starcoder2-3b and recurrentgemma-2b (B = 1; q, k, v from the
    port's projections and RoPE on a numpy-seeded layer, x ~ N(0, 1)).
    The main path — every case's layer through ops.attention and wo — runs
    with the launch counts zeroed just before and read just after: one
    launch per call. Then each output is held against
    flash_attention_plain (f32 rtol = atol = 2e-5; bf16 atol 5e-2 and
    every row within fa.BF16_ROW_REL of its norm), against
    blockwise_attention (f32 2e-5; bf16 rows within BF16_ORACLE_ROW_REL)
    and the layer against the port's self_attention (f32 relative
    Frobenius norm <= 1e-5; bf16 rows within BF16_ORACLE_ROW_REL), and two
    more launches must equal the main path's output bitwise; kernel, plain
    version and SDPA are timed with CUDA events. Returns the rows and the
    main-path run."""
    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels import flash_attention as fa
    t0 = time.perf_counter()
    from repro_torch.kernels import ops
    from repro_torch.models.attention import (attention_params_from_jax,
                                              blockwise_attention,
                                              self_attention)
    layers = []
    for i, (arch, s, causal, dtypes) in enumerate(ATTENTION_CASES):
        cfg = get_arch(arch)
        log(f"attention: {arch} d_model {cfg.d_model} H {cfg.num_heads} "
            f"K {cfg.num_kv_heads} d {cfg.resolved_head_dim} qkv_bias "
            f"{cfg.qkv_bias} qk_norm {cfg.qk_norm} rope_theta "
            f"{cfg.rope_theta} window {cfg.sliding_window}")
        np_params = attention_layer_params(cfg, seed=i)
        x = np.random.default_rng(100 + i).standard_normal(
            (1, s, cfg.d_model), dtype=np.float32)
        for dtype in dtypes:
            td = getattr(torch, dtype)
            p = {k: v.to(td) for k, v in
                 attention_params_from_jax(np_params, "cuda").items()}
            layers.append(dict(arch=arch, cfg=cfg, s=s, causal=causal,
                               dtype=dtype, p=p,
                               x=torch.from_numpy(x).to("cuda", td)))
    pos = torch.arange(max(c[1] for c in ATTENTION_CASES), device="cuda")

    # the main path: each layer through the kernel, counts zeroed around it
    reset_launches()
    for lay in layers:
        cfg, s = lay["cfg"], lay["s"]
        q, k, v = attention_qkv(lay["p"], cfg, lay["x"], pos[:s])
        out = ops.attention(q, k, v, causal=lay["causal"],
                            window=cfg.sliding_window)
        lay.update(q=q, k=k, v=v, out=out,
                   y=out.reshape(1, s, -1) @ lay["p"]["wo"])
    torch.cuda.synchronize()
    launches = read_launches()
    want = dict.fromkeys(KERNELS, 0)
    want["flash_attention"] = len(layers)
    assert launches == want, (launches, want)
    log(f"attention: {len(layers)} layers through ops.attention, launches "
        f"{launches['flash_attention']}")

    rows = []
    for lay in layers:
        cfg, s, causal, dtype = lay["cfg"], lay["s"], lay["causal"], lay["dtype"]
        q, k, v, out = lay["q"], lay["k"], lay["v"], lay["out"]
        w = cfg.sliding_window
        what = f"{lay['arch']} S={s} {'causal' if causal else 'full'} {dtype}"
        assert out.shape == q.shape and torch.isfinite(out).all(), what
        plain = (lambda q=q, k=k, v=v, c=causal, w=w:
                 fa.flash_attention_plain(q, k, v, causal=c, window=w))
        want = plain()
        f32 = dtype == "float32"
        torch.testing.assert_close(
            out, want, rtol=2e-5 if f32 else 0, atol=FLASH_ATOL[dtype],
            msg=lambda m, w=what: f"{w}: {m}")
        row = dict(arch=lay["arch"], s=s, causal=causal, window=w,
                   dtype=dtype, heads=cfg.num_heads, kv_heads=cfg.num_kv_heads,
                   head_dim=cfg.resolved_head_dim,
                   max_abs_err=float((out.float() - want.float()).abs().max()),
                   mean_abs_out=float(out.float().abs().mean()))
        if not f32:
            row["row_rel_err"] = fa.assert_rows_close(
                out, want, fa.BF16_ROW_REL, what)
            row["row_rel_limit"] = fa.BF16_ROW_REL
        del want
        blockwise = blockwise_attention(q, k, v, pos[:s], causal, w)
        row["blockwise_max_abs_err"] = float(
            (out.float() - blockwise.float()).abs().max())
        if f32:
            torch.testing.assert_close(out, blockwise, rtol=2e-5, atol=2e-5,
                                       msg=lambda m, w=what: f"{w}: {m}")
        else:
            row["blockwise_row_rel_err"] = fa.assert_rows_close(
                out, blockwise, BF16_ORACLE_ROW_REL, f"{what} blockwise")
        del blockwise
        layer = self_attention(lay["p"], cfg, lay["x"], pos[:s], causal=causal)
        if f32:
            row["layer_rel_norm"] = _rel_close(lay["y"], layer, what, rel=1e-5)
        else:
            row["layer_row_rel_err"] = fa.assert_rows_close(
                lay["y"], layer, BF16_ORACLE_ROW_REL, f"{what} layer")
        del layer
        kern = (lambda q=q, k=k, v=v, c=causal, w=w:
                fa.flash_attention(q, k, v, causal=c, window=w))
        lib = _sdpa(q, k, v, causal, w)
        row["library_max_abs_err"] = float((lib().float()
                                            - out.float()).abs().max())
        row["library"] = "sdpa: " + _sdpa_backend(lib)
        again = kern()
        assert torch.equal(again, kern()) and torch.equal(again, out), what
        row["bitwise_repeat"] = True
        del again
        row["ms"] = cuda_time_ms(kern, 5)
        row["plain_ms"] = cuda_time_ms(plain, 2)
        row["library_ms"] = cuda_time_ms(lib, 5)
        es = q.element_size()
        pairs = unmasked_pairs(s, s, causal, w)
        flops = 4.0 * q.shape[-1] * pairs * q.shape[0] * q.shape[2]
        nbytes = es * (2 * q.numel() + k.numel() + v.numel())
        # the tensor cores the kernel uses: 3×TF32 (three products) in f32
        t_ops = (3 * flops / PEAK_TF32_FLOPS if f32
                 else flops / PEAK_BF16_FLOPS)
        t_bytes = nbytes / PEAK_BYTES
        build = FLASH_BUILD[q.shape[-1], dtype]
        row.update(bound_ms=1e3 * max(t_ops, t_bytes),
                   bound_by="operations" if t_ops >= t_bytes else "bytes",
                   bound_fma_ms=1e3 * max(flops / PEAK_F32_FLOPS, t_bytes),
                   gflop=flops / 1e9, mbytes=nbytes / 1e6,
                   tflops=flops / row["ms"] / 1e9,
                   registers=build["registers"],
                   spill_bytes=build["spill_bytes"])
        row["bound_share"] = row["bound_ms"] / row["ms"]
        rows.append(row)
        log("attention: " + json.dumps(row))
    del layers
    torch.cuda.empty_cache()
    log(f"attention: phase took {time.perf_counter() - t0:.1f} s")
    return rows, dict(launches=launches)


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
    from repro_torch.device import exact_f32_matmul
    exact_f32_matmul()
    t_start = time.perf_counter()
    log(f"device: {torch.cuda.get_device_name(0)} (torch {torch.__version__}, "
        f"CUDA {torch.version.cuda})")
    phase_build()
    attention_rows, attention_run = phase_attention()
    pipelines = {}
    for name in ("reddit-sim", "yelp-sim"):
        t0 = time.perf_counter()
        pipelines[name] = p = GraphDataPipeline.build(
            name, 4, kind="sage", agg="fused", layout="auto", device="cuda")
        topo = p.topo
        log(f"pipeline: {name} P=4 layout={p.layout} max_inner "
            f"{topo.max_inner} halo {topo.halo_size} combined "
            f"{topo.max_inner + topo.halo_size} n_tiles "
            f"{topo.tile_rows.shape[1]} built in "
            f"{time.perf_counter() - t0:.2f} s")
    reddit, yelp = pipelines["reddit-sim"], pipelines["yelp-sim"]
    split_pipes = []
    for name, parts in SPLIT_GRAPHS:
        t0 = time.perf_counter()
        p = GraphDataPipeline.build(name, parts, kind="sage", agg="fused",
                                    layout="auto", device="cuda")
        split_pipes.append(p)
        log(f"pipeline: {name} P={parts} layout={p.layout} max_inner "
            f"{p.topo.max_inner} halo {p.topo.halo_size} n_tiles "
            f"{p.topo.tile_rows.shape[1]} split {p.split_spec()} built in "
            f"{time.perf_counter() - t0:.2f} s")
        assert p.split_spec() is not None, name
    rows = phase_kernels({k: p.topo for k, p in pipelines.items()})
    rows.update(phase_fused_kernels({k: p.topo for k, p in pipelines.items()}))
    rows.update(phase_phased_kernels(split_pipes))
    phase_steps(reddit, yelp)
    phase_split(split_pipes)
    phase_spmd(split_pipes[1])
    runs = phase_train(reddit, yelp, split_pipes)
    phase_step_times(reddit, yelp)
    phase_split_step_times(split_pipes)
    phase_exchange(split_pipes, runs)
    for p in split_pipes:
        phase_overlap(p)
    if "--profile" in argv:
        for agg in ("blocksparse", "fused"):
            phase_profile(reddit, agg)
    rows["flash_attention"] = attention_rows
    runs[ATTENTION_RUN] = attention_run
    kernels = [kernel_entry(name, rows[name], runs) for name in KERNELS]
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
