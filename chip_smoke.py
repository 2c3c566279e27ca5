"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py              # needs one CUDA card; exits non-zero otherwise
    python3 chip_smoke.py --profile    # also writes torch.profiler tables of
                                       # two training steps to chiprun_out/

Phases, in order; any failure ends the run with a non-zero exit:
  1. build   compile the CUDA kernels from the sources in this checkout
             (one nvcc per source, started together) and print the time;
             read every spmm, fused and flash-attention kernel instance's
             registers, spills and tensor-core instructions from the
             libraries (cuobjdump -res-usage, -sass): it fails on a spmm
             HMMA that is not TF32, on a fused instance that spills or has
             no HMMA or one that is not TF32, and on a flash instance that
             spills, a bf16 one without HMMA.16816.F32.BF16 (or with
             another HMMA) and an f32 one without HMMA or with one that is
             not TF32.
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
               512), z bit-equal to spmm's on the same h, and two more
               launches bitwise equal to the first; each call prints its
               work items, tiles walked (asserted equal to the nonzero
               tiles), longest item, and its instance's registers, spills
               and TF32 tensor-core instructions; yardstick the composed
               path: the port's spmm / spmm_t kernel plus torch.matmul,
               the same function unfused (the spmm kernel alone at the
               aggregation width and the composed path's dense product
               are timed beside it); the bound counts the least work of
               the function over both orders of the two products (with z,
               aggregate first only);
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
  7a. wire   the boundary wire codecs (core/codec.py: f32, bf16, int8,
             int4, auto) and feature slicing; every line carries the card's
             name and power limit:
             - encoders: each codec's encode / decode on the card equals
               the CPU's byte for byte on the first train step's real
               payloads (blocksparse/auto, sliced, per-layer exchange) at
               reddit-sim's widths 128, 256, 16 and yelp-sim's 120, 512,
               24; encode + decode timed per payload;
             - bytes: the bytes one reddit-sim P=4 train step hands the
               exchange (RecordingBackend) equal BENCH_8.json's
               meta.wire_bytes for f32, bf16, int8 and int4; the sliced
               auto plan's bytes beside them;
             - step: 2 reddit-sim steps (blocksparse/auto) under the int8
               wire against the COO engine in float64 under the same wire,
               at STEP_REL, the f32 wire's reading beside it, and the
               count of bytes that differ between the two runs' layer-0
               and layer-1 forward wires;
             - split: yelp-sim P=2 and grid-sim P=4 under int8, split
               bit-equal to unsplit, exact launch counts;
             - train: 5-epoch runs of reddit-sim blocksparse/auto under
               bf16, int8 and auto --slice-boundary, and of grid-sim under
               auto --slice-boundary (a mixed int8 + bf16 plan), each with
               exact launch counts and a finite loss, beside the f32 run;
             - step times: the reddit-sim train step under f32, bf16 and
               int8 in turns (median of 20 each), with the device
               launches and busy time of one profiled step each (the
               codec's launches per step = the difference to f32's).
  7b. faults the guarded exchange (per-row checksum column, stale
             fallback, "es" counters), fault injection, the staleness
             bound and checkpoint / resume; every line carries the card's
             name and power limit:
             - identity: checksum wires card == CPU byte for byte at
               reddit-sim's send shapes; 2 reddit-sim steps guarded vs
               unguarded,
               blocksparse/auto and fused/auto under f32 and int8 wires,
               bitwise, es all 0, exact launch counts;
             - drills: BENCH_9.json's three degraded tiny P=4 cells give
               its fallback counts on the card; reddit-sim P=4
               blocksparse/auto trains 10 epochs under a 5% drop plan
               (train_pipegcn, exact launches), its exchange_fallbacks and
               max_effective_staleness equal to the same plan's run of
               the COO engine in float64 on the card, whose first 2 steps
               hold the kernel run at STEP_REL with equal es;
             - corrupt: reddit-sim under a 2% corrupt plan flags only
               injected sites; rows changed, flagged and missed by the
               checksum are counted from the captured wires; 3 trainer
               steps (health guard on) keep the state finite;
             - checkpoint: reddit-sim at dropout 0.5, 6 epochs == 3 +
               resume bitwise (params, Adam moments, buffers, es, CUDA
               generator state), with the checkpoint's bytes and its save
               and restore ms;
             - step times: guarded vs unguarded reddit-sim step in turns
               (g, u, u, g), medians of 20, with one profiled step each.
  7c. elastic the elastic runtime (device-loss detection, survivor remap,
             warm recovery, rejoin) on reddit-sim P = 4 at full width,
             guarded, max_staleness 8, losing device 1 (3 survivors × 2
             partitions, 2 pads); every line carries the card's name and
             power limit:
             - kernels: spmm / spmm_t F = 256, spmm_fused 128→256 (z,
               ReLU) and spmm_fused_t 256←256 on the padded layout, into
               NaN-poisoned outputs: vs plain (1e-5; fused to scale), every
               row written, pad rows 0 (u: ReLU(b)), the pads' halo rows
               of δcomb 0, every workspace counter 0 after the launch;
               timed beside the original layout's launch;
             - drills: device 1 down at step 5, checkpoint every 4, 8
               epochs, under blocksparse/auto and fused/aggregate-first:
               one recovery, exact launches on both layouts, the
               device_losses of the COO engine in float64 on the card,
               recovery bitwise equal to a fresh survivor-layout launch
               from a copy of the checkpoint, and the wall time from
               detection to the first resumed step (restore, remap,
               schedule rebuild, first step); a rejoin drill (device 2
               down for [3, 5), 10 epochs) with exact launches;
             - steps: 2 padded guarded steps (exact launches, finite
               buffers, pads' es 0), the survivor-layout step against the
               original's in turns (medians of 20) with one profiled step
               each, exchanges per step and the buffers' bytes.
  7d. api    the GCN-side API (every line carries the card's name and
             power limit):
             - ops: the six kernels/ops.py entry points on partition 0's
               tile arrays, with the launch counts zeroed before and read
               after (one launch each, two per phased pair): reddit-sim
               P=4 spmm / spmm_t at F = 256, spmm_fused 128→256 with z,
               spmm_fused_t 256←256, yelp-sim P=2 spmm_phased /
               spmm_t_phased at F = 512 (both phases); each against its
               plain version (1e-5; the fused pair to scale) and bitwise
               against partition 0 of the stacked wrapper's launch
               (reported), with the host ms of building its schedule;
             - make_pipegcn_loss: 2 steps at reddit-sim P=4 full width
               under blocksparse/auto and fused/auto: loss, gradients and
               buffers bitwise equal to train_step's, the gradient of
               3·loss bitwise 3× the gradient, launches per step equal to
               train_step's and to expected_launches;
             - optim: adamw with linear_warmup_cosine and max_grad_norm, 5
               steps on the reddit-sim parameters, card vs CPU within 1e-6
               relative norm;
             - schedule: launch/check_schedule.py's five cells on the sim
               backend and on one NCCL rank holding 4 partitions;
             - examples: torch_quickstart (3 epochs) and
               torch_stale_halo_transformer (20 steps) on the card.
  7e. serve  the LM zoo's serve path (models/model.py LM.prefill /
             decode_step, launch/serve.py; plain PyTorch, no custom
             kernel, as in JAX); every line carries the card's name and
             power limit:
             - f32: qwen3-8b at full width and depth (36 layers, 8.20 B
               parameters) drawn on the card by LM.init_params, batch 4,
               prompt 64, 32 greedy decode steps: prefill's last logits
               vs forward_logits on the prompt (atol = rtol = 2e-4) and
               the decode logits of steps 0, 15 and 31 vs forward_logits
               on the prompt plus the tokens fed so far (3e-3 of the
               max-abs logit): tests/test_models_decode.py's bars; the f32
               prefill timed (TF32 off);
             - bf16: the same weights cast in place, served through
               serve_with (after a 4-step warm-up; it donates its caches,
               so each step writes its slot in place): prefill ms, decode
               ms per step and tok/s, the step's bytes bound (every weight
               but the embedding table, its 4 rows, the caches once and
               the logits, at 3.35 TB/s) and its share, the kernels and
               copies of one profiled decode step, the peak memory, the
               greedy tokens (its first 8 equal to serve_with's); decode
               logits at the three steps vs bf16 forward_logits within
               5e-2 of the max-abs logit, finite; then decode steps with
               caches of 32768 slots (qwen3-8b's context, 19.3 GB of KV),
               donated and copied (the default) in turns: ms per step,
               device busy, peak memory and the bound of each; then the
               model is freed;
             - mixers: mamba2-780m (SSD, prompt 300: two 256-token chunks
               and a ragged tail), recurrentgemma-2b (RG-LRU), granite-
               moe-1b-a400m (MoE), whisper-large-v3 (enc-dec, 1500
               frames) at full width and depth, deepseek-v2-236b (MLA,
               160 experts) at its published widths cut to 3 layers and
               llama-3.2-vision-11b (gated cross-attention, gates set to
               0.5) cut to 10, each in f32, drawn on the card, held to
               forward_logits at the f32 bars above (8 decode steps,
               steps 0, 3 and 7 checked) and freed; an MoE arch serves
               twice and repeats its logits bit for bit;
             - reduced: all ten archs through serve on the card, then the
               same parameters (drawn on the card) on the card and the
               CPU: prefill logits, every cache leaf and 4 decode steps'
               logits within 1e-4 in relative norm, the MoE routing
               indices equal, an MoE arch's card run repeated bit for
               bit.
  7f. lm_train the LM zoo's training path (models/model.py LM.loss_fn under
             autograd, remat by torch.utils.checkpoint, launch/train.py
             train_lm / run_lm / --workload lm; plain PyTorch, no custom
             kernel, as in JAX: the phase asserts zero launches of all seven);
             every line carries the card's name and power limit:
             - bf16: qwen3-8b at its published widths cut to 4 layers
               (2.02 B parameters), remat on, batch 8 x seq 128 from
               TokenStream, 20 steps of train_lm with adamw(
               linear_warmup_cosine(3e-4, 10, 20), max_grad_norm=1.0):
               every loss finite, the last below the first; then 8 steps
               timed with forward + backward and opt.apply apart (a sync
               after each), tokens/s, the model-FLOPs share (3 x forward
               FLOPs of analytic_cost / step time / 989 TFLOP/s), the peak
               memory beside the 24-bytes-per-parameter reckoning, and the
               device ops and busy time of one profiled step;
             - f32 vs f64: the same widths at 2 layers, one batch, the f32
               model (full f32 products) against the same parameters in
               f64 on the card: the loss within 1e-6 relative, every
               gradient leaf within 1e-4 in relative norm (a key bias
               without RoPE or qk-norm, whose exact gradient is 0, against
               its layer's wk gradient); remat on against off at that bar,
               bit-equality reported;
             - mixers: mamba2-780m, granite-moe-1b-a400m, whisper-large-v3
               whole and recurrentgemma-2b cut to 12 layers, bf16, 5 steps
               each (loss, ms per step, peak memory), then the f32-vs-f64
               check at a cut depth (2 layers; whisper 2 + 2 encoder
               layers; recurrentgemma one r-r-a unit), each model freed;
             - reduced: the ten archs through the CLI on the card (main(
               ["--workload", "lm", "--arch", a, "--reduced", "--steps",
               "3"])), then the same parameters through train_lm on the card
               (whether it repeats the CLI bit for bit is reported, with
               the backward's indexed-accumulation kernels where it does
               not) and on the CPU: every loss within 1e-5.
  7g. dryrun the production dry-run (launch/dryrun.py, dryrun_pipegcn.py):
             rank 0 of the 16×16 (256 ranks) or 2×16×16 (512) mesh on a
             fake process group, every collective a no-op, at its true
             production shapes on the card (every line carries the card's
             name and power limit):
             - PipeGCN at PROD (papers100M-scale rank 0: 434,176 inner
               nodes, 6,553,600 edges) on 16×16: pipegcn fused and per
               layer, vanilla, and fused under --overlap split-phase; at
               SMALL (Reddit-scale) on 2×16×16; the COO engine, as JAX's
               dry-run, so none of the seven kernels runs. Each: median
               step ms of 3, peak bytes beside the argument bytes,
               boundary collectives equal to expected_boundary_collectives
               (2 fused, 2L-1 per layer) and to the all-to-alls counted,
               the bytes handed to the exchange equal to JAX's wire-byte
               formula;
             - qwen3-8b on 16×16, all four shapes abstract (meta): argument
               bytes, bytes per device (StepMemory: arguments + the peak
               of the step's own storages), the collective table (count
               and bytes per type), roofline terms; then on the card every
               shape whose abstract bytes per device fit 75% of the card,
               train_4k and decode_32k at least: median step ms of 2, peak
               bytes beside the argument bytes (equal to the abstract
               run's) and the abstract bytes per device within 15% of it,
               the card's collective table beside the abstract one and
               equal to it, count and bytes of every type;
             - granite-moe train_4k --opt-sharding, abstract;
             - granite-moe and mamba2-780m train_4k on 16×16 on the card
               under global routing, whose abstract bytes per device must
               fit 75% of the card: median step ms of 2, peak bytes and
               the abstract bytes per device within 15% of it, the card's
               collectives equal to the abstract run's, count and bytes of
               every type;
             - after the timed card steps (so no step time is taken beside
               them), the dry-run's CLI, --all --shape S --device meta, one
               process per mesh and shape, all eight side by side: with
               the PipeGCN rows above, 40 of 40 LM rows per mesh under
               JAX's artifact gates (launch.dryrun.check_rows: no error,
               run_s > 0, t_compute >= 0, t_memory > 0, a bottleneck,
               train model-FLOPs ratio in (0.2, 1.3), no compute-bound
               decode, PipeGCN's all-to-all bytes > 0); against JAX's rows
               (tests/_dryrun_jax_rows.py, check_against_jax): every row's
               collectives counted and their total the sum of the types,
               its argument bytes JAX's or the int32 scalar fewer, an MoE
               row at least one all-reduce of its (tokens, d_model) output
               per MoE layer, the seven rows of ROADMAP F5 at most 4x
               JAX's collective bytes; each row's collective bytes beside
               JAX's; bytes per device; these rows include the 11 combos
               torch 2.11's DTensor refused before shardctx routed the ops;
             - no port kernel launched in the phase; the phase's time.
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
# (transpose, FB, ON) -> registers, spill bytes and TF32 tensor-core
# instruction count of that fused kernel instance
FUSED_BUILD = {}


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
    inst = re.compile(r"fused_items_kernelILb([01])ELi(\d+)ELi(\d+)E")
    res = _build.kernel_resources(results["gcn_spmm"][0])
    ops = _build.tensor_core_ops(results["gcn_spmm"][0])
    for name, r in res.items():
        m = inst.search(name)
        if not m:
            continue
        key = (m.group(1) == "1", int(m.group(2)), int(m.group(3)))
        o = ops.get(name, {})
        FUSED_BUILD[key] = dict(registers=r["registers"],
                                spill_bytes=r["stack"] + r["local"],
                                tf32_mma_in_sass=sum(o.values()))
        log(f"build: fused_items_kernel<transpose={key[0]}, FB={key[1]}, "
            f"ON={key[2]}>: {r['registers']} registers, stack + local "
            f"(spills) {r['stack'] + r['local']} bytes, SASS tensor-core "
            f"ops {o}")
        assert r["stack"] == 0 and r["local"] == 0, (key, r)
        assert o and all(op.endswith(".TF32") for op in o), (key, o)
    want = [(t, fb, on) for t in (False, True) for fb in (8, 16, 32, 64, 128)
            for on in (16, 64)]
    assert sorted(FUSED_BUILD) == sorted(want), sorted(FUSED_BUILD)


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


def schedule_stats(items, blocks, transpose: bool, f: int, n_nonzero: int,
                   n_out: int | None = None):
    """What one spmm call (a fused call with n_out epilogue columns, its
    aggregation at width f) walks: its work items (those of the output
    blocks `blocks`), the tiles they walk, which must equal the call's
    n_nonzero tiles, and the longest item, at most SCHED_CHUNK; with the
    kernel instance's registers, shared memory (spmm) or spill bytes
    (fused) and TF32 tensor-core instruction count."""
    from repro_torch.kernels import gcn_spmm
    it = items.cpu().numpy()
    b, e = blocks
    sel = (it[..., 0] >= b) & (it[..., 0] < e)
    walked = (it[..., 2] - it[..., 1])[sel]
    fb = gcn_spmm.feature_block(f)
    out = dict(items=int(sel.sum()), tiles_walked=int(walked.sum()),
               nonzero_tiles=n_nonzero, longest_item=int(walked.max()),
               chunk=gcn_spmm.SCHED_CHUNK, fb=fb, slices=-(-f // fb))
    if n_out is None:
        out.update(registers=SPMM_BUILD[transpose, fb][0],
                   smem_bytes=gcn_spmm.smem_bytes(fb),
                   tf32_mma_in_sass=SPMM_BUILD[transpose, fb][1])
    else:
        on = gcn_spmm.epilogue_block(n_out)
        out.update(on=on, **FUSED_BUILD[transpose, fb, on])
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

    def check_and_time(kernel, row, kern, comp, agg, matmul, outs):
        """Two more launches bitwise equal to the first (outs); kernel and
        composed timed in turns; the spmm kernel alone at the aggregation
        width and the composed path's dense product beside them."""
        again = [kern(), kern()]
        for out in again:
            out = out if isinstance(out, tuple) else (out,)
            assert all(a is None and b is None or torch.equal(a, b)
                       for a, b in zip(out, outs)), kernel
        row["bitwise_repeat"] = True
        row["ms"], row["composed_ms"] = _timed_pair(kern, comp)
        row["agg_ms"] = cuda_time_ms(agg, 20)
        row["composed_matmul_ms"] = cuda_time_ms(matmul, 20)
        row["epilogue_share"] = max(0.0, row["ms"] - row["agg_ms"]) / row["ms"]

    def record(kernel, row, flops, nbytes):
        row.update(gcn_bound(flops, nbytes))
        row["bound_share"] = row["bound_ms"] / row["ms"]
        rows[kernel].append(row)
        log(f"kernels: {kernel} {row['graph']} F_in {row['fin']} F_out "
            f"{row['fout']}{' z' if row.get('with_z') else ''}"
            f"{' relu' if row.get('relu') else ''} max_abs_err "
            f"{row['max_abs_err']:.3g} kernel {row['ms']:.4f} ms composed "
            f"{row['composed_ms']:.4f} ms (its matmul "
            f"{row['composed_matmul_ms']:.4f}) spmm kernel at the "
            f"aggregation width {row['agg_ms']:.4f} ms (epilogue share "
            f"{row['epilogue_share']:.3f}) plain "
            f"{row['plain_ms']:.4f} ms bound {row['bound_ms']:.4f} ms "
            f"({row['bound_by']}, share {row['bound_share']:.3f}; f32 FMA "
            f"{row['bound_fma_ms']:.4f}); {json.dumps(row['schedule'])}")

    for name, fin, fout, with_z, relu in fwd_cases:
        topo, fields, P, R, C, n_nz = shapes(name)
        h = torch.randn(P, C, fin, device="cuda", generator=gen)
        w = torch.randn(fin, fout, device="cuda", generator=gen) / fin ** 0.5
        b = 0.1 * torch.randn(fout, device="cuda", generator=gen)
        args = (topo.tile_work, topo.tile_items, topo.tile_rows,
                topo.tile_cols, topo.tile_vals, h, w, b, R)
        kern = (lambda a=args, z=with_z, r=relu:
                gcn_spmm.spmm_fused(*a, relu=r, with_z=z))
        plain = (lambda a=args, z=with_z, r=relu:
                 gcn_spmm.spmm_fused_plain(*a[2:], relu=r, with_z=z))
        comp = (lambda f=fields, h=h, w=w, b=b, z=with_z, r=relu:
                composed.aggregate_transform(f, h, w, b, R, relu=r, with_z=z))
        agg = lambda a=args: gcn_spmm.spmm(*a[:6], R)      # noqa: E731
        (u, z), (pu, pz) = kern(), plain()
        torch.cuda.synchronize()
        err = gcn_spmm.assert_close_to_scale(
            u, pu, f"spmm_fused {name} {fin}->{fout}")
        zz = agg()
        if with_z:
            err = max(err, gcn_spmm.assert_close_to_scale(
                z, pz, f"spmm_fused z {name} {fin}->{fout}"))
            assert torch.equal(z, zz), f"spmm_fused z {name}: not spmm's"
        row = dict(graph=name, fin=fin, fout=fout, with_z=with_z, relu=relu,
                   max_abs_err=err, z_bit_equal_spmm=with_z,
                   schedule=schedule_stats(topo.tile_items,
                                           (0, -(-R // 128)), False, fin,
                                           n_nz, n_out=fout))
        check_and_time("spmm_fused", row, kern, comp, agg,
                       lambda zz=zz, w=w, b=b: zz @ w + b, (u, z))
        row["plain_ms"] = cuda_time_ms(plain, 5)
        # the least work of the function: aggregate first (z is produced
        # there, so with z no other order), or transform first
        agg_first = 2.0 * n_nz * 128 * 128 * fin + 2.0 * P * R * fin * fout
        tf_first = 2.0 * P * C * fin * fout + 2.0 * n_nz * 128 * 128 * fout
        flops = agg_first if with_z else min(agg_first, tf_first)
        nbytes = 4.0 * (n_nz * 128 * 128 + P * C * fin + fin * fout + fout
                        + P * R * fout + (P * R * fin if with_z else 0))
        record("spmm_fused", row, flops, nbytes)
    for name, fin, fout in bwd_cases:
        topo, fields, P, R, C, n_nz = shapes(name)
        du = torch.randn(P, R, fout, device="cuda", generator=gen)
        w = torch.randn(fin, fout, device="cuda", generator=gen) / fout ** 0.5
        args = (topo.tile_t_work, topo.tile_t_items, topo.tile_t_out,
                topo.tile_t_in, topo.tile_t_perm, topo.tile_vals, du, w, C)
        kern = lambda a=args: gcn_spmm.spmm_fused_t(*a)        # noqa: E731
        plain = lambda a=args: gcn_spmm.spmm_fused_t_plain(*a[2:])  # noqa: E731
        comp = (lambda f=fields, du=du, w=w:
                composed.aggregate_transform_t(f, du, w, C))
        agg = lambda a=args: gcn_spmm.spmm_t(*a[:7], C)     # noqa: E731
        got, want = kern(), plain()
        torch.cuda.synchronize()
        err = gcn_spmm.assert_close_to_scale(
            got, want, f"spmm_fused_t {name} {fin}<-{fout}")
        row = dict(graph=name, fin=fin, fout=fout, max_abs_err=err,
                   schedule=schedule_stats(topo.tile_t_items,
                                           (0, -(-C // 128)), True, fout,
                                           n_nz, n_out=fin))
        check_and_time("spmm_fused_t", row, kern, comp, agg,
                       lambda du=du, w=w: du @ w.T, (got,))
        row["plain_ms"] = cuda_time_ms(plain, 5)
        # the least work over both associations: Pᵀ·(du·wᵀ), the dense
        # product once per input row and the aggregation at F_in, or
        # (Pᵀ·du)·wᵀ, the aggregation at F_out and the product once per
        # output row
        flops = min(2.0 * n_nz * 128 * 128 * fin + 2.0 * P * R * fin * fout,
                    2.0 * n_nz * 128 * 128 * fout + 2.0 * P * C * fin * fout)
        nbytes = 4.0 * (n_nz * 128 * 128 + P * R * fout + fin * fout
                        + P * C * fin)
        record("spmm_fused_t", row, flops, nbytes)
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


def launch_counters() -> dict:
    """kernel name -> the `repro_torch.spans` counter of its wrapper's
    kernel launches."""
    return {k: ("flash_attention." if k == "flash_attention" else "gcn_spmm.")
            + k for k in KERNELS}


_LAUNCHES_AT_RESET: dict = {}


def reset_launches():
    """Start counting launches from here (`read_launches` gives the
    launches since)."""
    from repro_torch import spans
    _LAUNCHES_AT_RESET.update({k: spans.counter(c)
                               for k, c in launch_counters().items()})


def read_launches() -> dict:
    from repro_torch import spans
    return {k: spans.counter(c) - _LAUNCHES_AT_RESET.get(k, 0)
            for k, c in launch_counters().items()}


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


def train_run(pipeline, agg, order, pipe=None, what=""):
    """One main path: train_pipegcn for EPOCHS epochs under `pipe`
    (default the pipegcn variant), with every launch count zeroed just
    before and read just after; the counts must equal expected_launches.
    `what` names the pipe in the log lines."""
    import dataclasses
    from repro_torch import spans
    from repro_torch.core import PipeConfig, PipeGCN, train_pipegcn
    from repro_torch.core.trace_utils import expected_boundary_collectives
    name = graph_name(pipeline)
    pipe = PipeConfig.named("pipegcn") if pipe is None else pipe
    tag = f"{name} {agg}/{order}{what}"
    mc, lr = _model_config(pipeline, agg, order)
    reset_launches()
    res = train_pipegcn(pipeline, mc, pipe,
                        epochs=EPOCHS, lr=lr, seed=0, eval_every=EVAL_EVERY,
                        log=lambda s: log(f"train {tag}: {s}"),
                        device="cuda")
    launches = read_launches()
    copies = spans.last_run()["counters"].get("exchange.side_copies", 0)
    model = PipeGCN(mc, pipe, split=pipeline.split_spec())
    n_eval = len(res.history["epoch"])
    expect = expected_launches(model, pipeline.topo, EPOCHS, n_eval)
    assert all(math.isfinite(v) for v in res.history["loss"]), res.history
    assert launches == expect, (tag, launches, expect)
    # the split starts every exchange on the side stream: 2 per fused
    # train step (2L-1 per layer), L per (vanilla) eval forward; the
    # unsplit step none (feature slicing keeps training unsplit)
    L = mc.num_layers
    evaluator = dataclasses.replace(model, pipe=PipeConfig.vanilla())
    want = ((EPOCHS * expected_boundary_collectives(L, pipe.fused)
             if model._split_active() is not None else 0)
            + (n_eval * L if evaluator._split_active() is not None else 0))
    assert copies == want, (tag, copies, want)
    launches["side_stream_copies"] = copies
    log(f"train {tag}: loss {res.history['loss'][-1]:.4f} "
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
    "spmm_fused": ("src/repro/kernels/gcn_spmm.py:370", "gcn_spmm.cu",
                   ("reddit-sim P=4", "fused", "auto"),
                   dict(graph="reddit-sim", fin=128, fout=256)),
    "spmm_fused_t": ("src/repro/kernels/gcn_spmm.py:458", "gcn_spmm.cu",
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


# ---------------------------------------------------------------------
# Phase "wire": the boundary wire codecs (core/codec.py) and feature
# slicing on the card
# ---------------------------------------------------------------------

WIRE_WIDTHS = {"reddit-sim": (16, 128, 256), "yelp-sim": (24, 120, 512)}


def _capture(inner):
    """A RecordingBackend around `inner` that also keeps every tensor it
    hands the exchange, in order, in `sent`."""
    from repro_torch.core.trace_utils import RecordingBackend

    class Capture(RecordingBackend):
        def __init__(self, inner):
            super().__init__(inner)
            self.sent = []

        def exchange(self, s):
            self.sent.append(s)
            return super().exchange(s)

        def start_exchange(self, s):
            self.sent.append(s)
            return super().start_exchange(s)

    return Capture(inner)


def _raw(t):
    """The bytes of a tensor (any dtype), flat, on the host."""
    import torch
    return t.contiguous().reshape(-1).view(torch.uint8).cpu()


def _wire_encoders(pipeline, card):
    """Every codec on the first train step's real payloads of the graph's
    full-width model (blocksparse/auto, sliced, per-layer exchange, so
    each exchanged tensor is one layer's f32 payload): the card's wire
    and its decode equal the CPU's byte for byte; encode + decode timed
    with CUDA events per payload."""
    import torch
    from repro_torch.core import codec
    from repro_torch.core.pipegcn import SimBackend
    name = pipeline.dataset.name
    model, _ = split_model(pipeline, "blocksparse", dropout=0.0,
                           fuse_exchange=False, slice_boundary=True)
    cap = _capture(SimBackend())
    params = model.init_params(torch.Generator(device="cuda").manual_seed(0))
    model.train_step(pipeline.topo, params,
                     model.init_buffers(pipeline.topo), pipeline.train_data,
                     backend=cap)
    payloads = {}
    for s in cap.sent:
        payloads.setdefault(int(s.shape[-1]), s)
    assert tuple(sorted(payloads)) == WIRE_WIDTHS[name], sorted(payloads)
    rows = []
    for f, x in sorted(payloads.items()):
        assert x.dtype == torch.float32 and x.is_cuda
        for wire in codec.WIRE_FORMATS:
            c = codec.make_codec(wire)
            w_card, w_cpu = c.encode(x), c.encode(x.cpu())
            assert w_card.dtype == w_cpu.dtype and w_card.is_cuda
            assert torch.equal(_raw(w_card), _raw(w_cpu)), (name, f, wire)
            d_card = c.decode(w_card, f, torch.float32)
            d_cpu = c.decode(w_cpu, f, torch.float32)
            assert torch.equal(_raw(d_card), _raw(d_cpu)), (name, f, wire)
            ms = cuda_time_ms(lambda: c.decode(c.encode(x), f, torch.float32),
                              reps=20)
            rows.append(dict(graph=name, f=f, wire=wire,
                             shape=list(x.shape),
                             wire_bytes=w_card.numel() * w_card.element_size(),
                             encode_decode_ms=ms,
                             max_abs_err=float((d_card - x).abs().max())))
    log(f"wire encoders [{card}]: {name} payloads {sorted(payloads)} x "
        f"{list(codec.WIRE_FORMATS)}: card wires == CPU wires and card "
        "decodes == CPU decodes, byte for byte")
    for r in rows:
        log(f"wire encoders [{card}]: " + json.dumps(r))
    return rows


def _wire_bytes(reddit, card):
    """The bytes one reddit-sim P=4 train step (fused exchange, the
    published model) hands the exchange under each wire, counted by
    RecordingBackend on the card, against BENCH_8.json's meta.wire_bytes;
    the sliced auto plan beside them."""
    from repro_torch.core.trace_utils import step_wire_bytes
    with open(os.path.join(ROOT, "benchmarks", "baselines",
                           "BENCH_8.json")) as f:
        want = json.load(f)["meta"]["wire_bytes"]
    got = {}
    for wire in ("f32", "bf16", "int8", "int4"):
        model, _ = split_model(reddit, "blocksparse", dropout=0.0, wire=wire)
        got[wire] = step_wire_bytes(model, reddit.topo, reddit.train_data)
        assert got[wire] == want[wire]["bytes"], (wire, got[wire], want[wire])
    model, _ = split_model(reddit, "blocksparse", dropout=0.0, wire="auto",
                           slice_boundary=True)
    got["auto --slice-boundary"] = step_wire_bytes(model, reddit.topo,
                                                   reddit.train_data)
    plan = [f"{c.name}x{w}" for c, w in zip(
        model.wire_codecs(reddit.topo), model.payload_widths(reddit.topo))]
    log(f"wire bytes [{card}]: reddit-sim P=4 train step, bytes handed to "
        f"the exchange {json.dumps(got)} (BENCH_8.json meta.wire_bytes: "
        f"{json.dumps({w: v['bytes'] for w, v in want.items()})}; equal); "
        f"auto --slice-boundary plan {plan}")
    return got


def _replay(inner, wires):
    """A backend around `inner` that hands the exchange the tensors
    `wires` (another run's sends, in order) in place of its own, cast to
    the dtype of its own."""
    from repro_torch.core.trace_utils import RecordingBackend

    class Replay(RecordingBackend):
        def exchange(self, s):
            w = wires.pop(0)
            assert w.shape == s.shape, (w.shape, s.shape)
            return super().exchange(w.to(s.dtype))

    return Replay(inner)


def _wire_step_check(reddit, wire, card):
    """2 reddit-sim train steps (blocksparse/auto, f32, dropout 0) under
    `wire` against the COO engine in float64 under the same wire, per
    leaf in relative norm, two ways. Free-running, each run encodes its
    own payloads: a payload element within rounding of an int8 level
    boundary lands on the neighbouring level in one of them, a jump of
    amax/127 that f32 rounding alone does not make; that reading is
    printed, with the count of bytes that differ between the two runs'
    layer-0 and layer-1 forward wires. Fed the same wire bytes (the
    float64 run receives, at each exchange, what the kernel run sent),
    the float64 run bounds the kernel path's own error, held at
    STEP_REL as in phase steps."""
    import dataclasses
    import torch
    from repro_torch.core import PipeConfig, PipeGCN
    from repro_torch.core.pipegcn import SimBackend
    pipe = dataclasses.replace(PipeConfig.named("pipegcn"), wire=wire)
    mc, _ = _model_config(reddit, "blocksparse", "auto")
    mc = dataclasses.replace(mc, dropout=0.0)
    kernels = PipeGCN(mc, pipe)
    coo = PipeGCN(dataclasses.replace(mc, agg="coo"), pipe)
    params0 = coo.init_params(torch.Generator(device="cuda").manual_seed(0))
    f64 = (reddit.topo.to(torch.float64), _float64(reddit.train_data))
    runs = {"kernels": (kernels, reddit.topo, reddit.train_data),
            "coo-f64": (coo,) + f64, "coo-f64 same wire": (coo,) + f64}
    state = {r: ({k: v.to(data.x.dtype) for k, v in params0.items()},
                 m.init_buffers(topo, dtype=data.x.dtype))
             for r, (m, topo, data) in runs.items()}
    widths = [c.wire_width(f) for c, f in zip(
        kernels.wire_codecs(reddit.topo), kernels.payload_widths(reddit.topo))]
    diffs = {"coo-f64": [], "coo-f64 same wire": []}
    differing = []
    for t in range(2):
        out, sent = {}, {}
        for r, (m, topo, data) in runs.items():
            backend = (_replay(SimBackend(), list(sent["kernels"]))
                       if r == "coo-f64 same wire" else _capture(SimBackend()))
            params, bufs = state[r]
            loss, grads, bufs, _ = m.train_step(topo, params, bufs, data,
                                                backend=backend)
            out[r] = (loss, grads, bufs)
            sent[r] = getattr(backend, "sent", None)
            state[r] = ({k: params[k] - 0.01 * grads[k] for k in params},
                        bufs)
        names = (["loss"] + [f"grad {k}" for k in grads]
                 + [f"{kind}[{ell}]" for kind in ("feat", "grad")
                    for ell in range(len(bufs[kind]))])
        for ref in diffs:
            # no assertion yet: the readings and the wire bytes print first
            step = _leaf_diffs(out["kernels"], out[ref],
                               f"reddit-sim wire {wire} step {t}", rel=1e30)
            diffs[ref] += [(d, f"step {t} {n}") for d, n in zip(step, names)]
        if wire != "f32":
            # the forward pack is the step's first exchange
            a, b = sent["kernels"][0], sent["coo-f64"][0]
            assert a.dtype == b.dtype == torch.uint8 and a.shape == b.shape
            cuts = [0, widths[0], widths[0] + widths[1]]
            differing.append([int((a[..., lo:hi] != b[..., lo:hi]).sum())
                              for lo, hi in zip(cuts, cuts[1:])])
    row = dict(wire=wire, bar=STEP_REL,
               loss=float(out["kernels"][0]),
               loss_coo_f64=float(out["coo-f64"][0]))
    for ref, ds in diffs.items():
        worst, leaf = max(ds)
        row[ref] = dict(worst_leaf_rel=worst, worst_leaf=leaf,
                        leaves_over_bar=[n for d, n in ds if d > STEP_REL])
    if wire != "f32":
        row["differing_wire_bytes_layer0_layer1"] = differing
        row["layer0_layer1_wire_bytes"] = [
            reddit.topo.num_parts ** 2 * reddit.topo.slot * w
            for w in widths[:2]]
    log(f"wire step [{card}]: " + json.dumps(row))
    worst = row["coo-f64 same wire"]["worst_leaf_rel"]
    assert worst <= STEP_REL, (wire, worst, STEP_REL)
    return row


def _wire_split(split_pipes, card):
    """The split step under the int8 wire, 2 steps at dropout 0 per split
    graph: bit-equal to the unsplit step, exact launch counts."""
    for pipeline in split_pipes:
        name = graph_name(pipeline)
        unsplit, _ = split_model(pipeline, "blocksparse", "none",
                                 dropout=0.0, wire="int8")
        ref = _steps(unsplit, pipeline, 2)
        model, _ = split_model(pipeline, "blocksparse", "auto", dropout=0.0,
                               wire="int8")
        assert model._split_active() is not None, name
        reset_launches()
        got = _steps(model, pipeline, 2)
        launches = read_launches()
        expect = expected_launches(model, pipeline.topo, 2, 0)
        assert launches == expect, (name, launches, expect)
        _bit_equal(got, ref, f"{name} int8 split vs unsplit")
        log(f"wire split [{card}]: {name} blocksparse/auto int8 split == "
            f"unsplit bitwise over 2 steps (loss {float(ref[-1][0]):.6f}), "
            f"launches {launches}")


def _wire_train(reddit, grid, runs, card):
    """5-epoch main paths under the wire codecs, each with exact launch
    counts and a finite loss, beside the f32 wire's run of phase train."""
    import dataclasses
    from repro_torch.core import PipeConfig
    base = PipeConfig.named("pipegcn")
    cases = ((reddit, "bf16", False), (reddit, "int8", False),
             (reddit, "auto", True), (grid, "auto", True))
    out = {}
    for pipeline, wire, sliced in cases:
        what = f" wire {wire}" + (" --slice-boundary" if sliced else "")
        pipe = dataclasses.replace(base, wire=wire, slice_boundary=sliced)
        run = train_run(pipeline, "blocksparse", "auto", pipe, what)
        f32 = runs[graph_name(pipeline), "blocksparse", "auto"]
        out[graph_name(pipeline), wire, sliced] = run
        log(f"wire train [{card}]: {graph_name(pipeline)} blocksparse/auto"
            f"{what}: loss {run['loss']:.4f} val {run['val']:.4f} (f32 "
            f"wire: loss {f32['loss']:.4f} val {f32['val']:.4f}); launches "
            f"{run['launches']}; epochs/s {run['epochs_per_sec']:.3f}")
    return out


def _device_kernels(fn) -> dict:
    """Device kernels and copies of one profiled call of fn: name ->
    (count, ms)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key: (e.count, getattr(e, "self_device_time_total",
                                     getattr(e, "self_cuda_time_total", 0))
                    / 1e3)
            for e in prof.key_averages()
            if getattr(e, "device_type", None) == DeviceType.CUDA}


def _device_launches(step, state) -> tuple[int, float]:
    """Device kernels and copies (count, busy ms) of one profiled step."""
    kernels = _device_kernels(lambda: _timed_steps(step, state, 1))
    return (sum(n for n, _ in kernels.values()),
            sum(ms for _, ms in kernels.values()))


def _wire_step_times(reddit, card):
    """reddit-sim blocksparse/auto train step (the pipegcn variant, fused
    exchange) under the f32, bf16 and int8 wires: 2 warm-up steps, then
    10 steps each in turns (f32, bf16, int8, int8, bf16, f32), medians of
    20; then one profiled step each for its device launches and busy
    time: the codec's launches per step are the difference to f32's."""
    import dataclasses
    import torch
    from repro_torch.core import (HealthConfig, PipeConfig, PipeGCN,
                                  make_train_step)
    from repro_torch.optim import adam
    wires = ("f32", "bf16", "int8")
    state = {}
    for wire in wires:
        mc, lr = _model_config(reddit, "blocksparse", "auto")
        model = PipeGCN(mc, dataclasses.replace(PipeConfig.named("pipegcn"),
                                                wire=wire))
        opt = adam(lr)
        params = model.init_params(
            torch.Generator(device="cuda").manual_seed(0))
        state[wire] = (make_train_step(model, opt, HealthConfig()), [
            reddit.topo, params, opt.init(params),
            model.init_buffers(reddit.topo), reddit.train_data,
            torch.Generator(device="cuda").manual_seed(1)])
        _timed_steps(*state[wire], 2)
    times = {w: [] for w in wires}
    for wire in wires + wires[::-1]:
        times[wire] += _timed_steps(*state[wire], 10)
    prof = {w: _device_launches(*state[w]) for w in wires}
    out = {}
    for wire, ts in times.items():
        q = sorted(ts)
        out[wire] = dict(median=(q[9] + q[10]) / 2, q1=q[4], q3=q[14],
                         max=q[-1], device_launches=prof[wire][0],
                         codec_launches=prof[wire][0] - prof["f32"][0],
                         device_busy_ms=prof[wire][1],
                         codec_busy_ms=prof[wire][1] - prof["f32"][1])
    log(f"wire step times [{card}]: reddit-sim P=4 blocksparse/auto train "
        f"step ms (20 steps each, in turns): {json.dumps(out)}")
    return out


def phase_wire(reddit, yelp, split_pipes, runs):
    """The boundary wire codecs and feature slicing on the card: encoders
    (card == CPU), exact bytes per step, the int8 step against float64,
    the split under int8, 5-epoch runs with exact launches, step times."""
    t0 = time.perf_counter()
    card = nvidia_smi_line()
    out = dict(encoders=_wire_encoders(reddit, card)
               + _wire_encoders(yelp, card),
               bytes=_wire_bytes(reddit, card),
               steps=[_wire_step_check(reddit, w, card)
                      for w in ("f32", "int8")])
    _wire_split(split_pipes, card)
    out["train"] = _wire_train(reddit, split_pipes[1], runs, card)
    out["step_times"] = _wire_step_times(reddit, card)
    log(f"wire: phase took {time.perf_counter() - t0:.1f} s")
    return out


# ---------------------------------------------------------------------
# Phase "faults": the guarded exchange, fault injection, the staleness
# bound and checkpoint / resume on the card
# ---------------------------------------------------------------------

def _faults_identity(reddit, card):
    """The checksum wires of every codec on the card equal the CPU's byte
    for byte (N(0,1) payloads of reddit-sim's send shapes); then 2
    reddit-sim steps (dropout 0) with the guard and without it, for
    blocksparse/auto and fused/auto under the f32 and int8 wires: bitwise
    equal, "es" all zero, and the guarded run's launches exactly
    expected_launches (the guard adds no spmm or fused launch)."""
    import torch
    from repro_torch.core import codec
    topo = reddit.topo
    gen = torch.Generator(device="cuda").manual_seed(5)
    for f in WIRE_WIDTHS["reddit-sim"]:
        x = torch.randn(topo.num_parts, topo.num_parts, topo.slot, f,
                        generator=gen, device="cuda")
        for wire in codec.WIRE_FORMATS:
            c = codec.make_codec(wire, guard=True)
            w_card, w_cpu = c.encode(x), c.encode(x.cpu())
            assert torch.equal(_raw(w_card), _raw(w_cpu)), (f, wire)
            assert c.decode_checked(w_card, f, torch.float32)[1].all()
    rows = []
    for agg in ("blocksparse", "fused"):
        for wire in ("f32", "int8"):
            ref, _ = split_model(reddit, agg, dropout=0.0, wire=wire)
            grd, _ = split_model(reddit, agg, dropout=0.0, wire=wire,
                                 guard_exchange=True)
            want = _steps(ref, reddit, 2)
            reset_launches()
            got = _steps(grd, reddit, 2)
            launches = read_launches()
            expect = expected_launches(grd, reddit.topo, 2, 0)
            assert launches == expect, (agg, wire, launches, expect)
            _bit_equal(want, got, f"guarded {agg}/{wire}")
            assert all(int(s[2]["es"].abs().max()) == 0 for s in got)
            rows.append(dict(agg=agg, wire=wire, launches=launches,
                             loss=float(got[-1][0])))
    log(f"faults identity [{card}]: checksum wires (every codec, reddit-sim "
        f"payload shapes at widths {WIRE_WIDTHS['reddit-sim']}) card == CPU "
        "byte for byte; reddit-sim P=4 guarded == unguarded bitwise over 2 "
        f"steps, es all 0, exact launches: {json.dumps(rows)}")
    return rows


def _fault_steps(model, topo, data, params, tables, n, backend=None):
    """n guarded steps from `params` under `tables`, plain SGD between
    them; returns ([(loss, grads, buffers)], anomalies) with the
    trainer's staleness bookkeeping."""
    from repro_torch.core.trainer import _check_staleness
    anomalies = {"exchange_fallbacks": 0,
                 "max_effective_staleness": model.pipe.staleness_steps}
    bufs = model.init_buffers(topo, dtype=data.x.dtype)
    out = []
    for t in range(n):
        loss, grads, bufs, _ = model.train_step(topo, params, bufs, data,
                                                backend=backend, step_idx=t,
                                                faults=tables)
        _check_staleness(bufs["es"].cpu().numpy(), model.pipe, anomalies, t)
        out.append((loss, grads, bufs))
        params = {k: params[k] - 0.01 * grads[k] for k in params}
    return out, anomalies


def _faults_drills(reddit, card):
    """The fault drills on the card: BENCH_9.json's three degraded tiny
    cells (exact fallback counts); reddit-sim P=4 blocksparse/auto for 10
    epochs under a 5% drop plan (seed 1) through train_pipegcn with exact
    launches, its counters equal to the same plan's run of the COO engine
    in float64 on the card, and its first 2 steps (dropout 0) against
    that run at STEP_REL."""
    import dataclasses
    import torch
    from repro_torch.core import (ModelConfig, PipeConfig, PipeGCN,
                                  train_pipegcn)
    from repro_torch.core.faults import FaultPlan
    from repro_torch.data import GraphDataPipeline
    with open(os.path.join(ROOT, "benchmarks", "baselines",
                           "BENCH_9.json")) as f:
        meta = json.load(f)["meta"]["faults"]
    tiny = GraphDataPipeline.build(meta["dataset"], 4, kind="sage",
                                   device="cuda")
    ds = tiny.dataset
    mc = ModelConfig(kind="sage", feat_dim=ds.feat_dim, hidden=32,
                     num_layers=3, num_classes=ds.num_classes, dropout=0.0,
                     multilabel=ds.multilabel)
    plan = FaultPlan(rate=0.05, rate_kind="drop", seed=1)
    cells = {}
    for cell, want in meta["degraded"].items():
        variant, wire, k = cell.split("/")
        k = int(k[1:])
        pc = dataclasses.replace(PipeConfig.named(variant, gamma=0.95),
                                 wire=wire, staleness_steps=k,
                                 guard_exchange=True,
                                 max_staleness=max(8, k + 4))
        res = train_pipegcn(tiny, mc, pc, epochs=meta["epochs"],
                            eval_every=meta["epochs"], device="cuda",
                            faults=plan)
        got = (res.anomalies["exchange_fallbacks"],
               res.anomalies["max_effective_staleness"])
        assert got == (want["fallbacks"], want["es_max"]), (cell, got, want)
        cells[cell] = got
    log(f"faults drills [{card}]: BENCH_9.json degraded cells on the card "
        f"(fallbacks, es max): {json.dumps(cells)} == the JSON's")

    epochs = 10
    pipe = dataclasses.replace(PipeConfig.named("pipegcn"),
                               guard_exchange=True)
    mc, lr = _model_config(reddit, "blocksparse", "auto")
    reset_launches()
    res = train_pipegcn(reddit, mc, pipe, epochs=epochs, lr=lr, seed=0,
                        eval_every=EVAL_EVERY, faults=plan, device="cuda",
                        log=lambda s: log(f"faults drill reddit-sim: {s}"))
    launches = read_launches()
    model = PipeGCN(mc, pipe, split=reddit.split_spec())
    n_eval = len(res.history["epoch"])
    expect = expected_launches(model, reddit.topo, epochs, n_eval)
    assert launches == expect, (launches, expect)
    assert all(math.isfinite(v) for v in res.history["loss"]), res.history
    tables = plan.compile(epochs, mc.num_layers, reddit.topo.num_parts,
                          device="cuda")
    kern, _ = split_model(reddit, "blocksparse", dropout=0.0,
                          guard_exchange=True)
    coo, _ = split_model(reddit, "coo", dropout=0.0, guard_exchange=True)
    params0 = coo.init_params(torch.Generator(device="cuda").manual_seed(0))
    f64_topo, f64_data = reddit.topo.to(torch.float64), _float64(
        reddit.train_data)
    ref, ref_anom = _fault_steps(
        coo, f64_topo, f64_data, {k: v.double() for k, v in params0.items()},
        tables, epochs)
    got, _ = _fault_steps(kern, reddit.topo, reddit.train_data, params0,
                          tables, 2)
    diffs = []
    for t in range(2):
        diffs += _leaf_diffs(got[t], ref[t], f"faults drill step {t}",
                             STEP_REL)
        assert torch.equal(got[t][2]["es"], ref[t][2]["es"]), t
    keys = ("exchange_fallbacks", "max_effective_staleness")
    drill = {k: res.anomalies[k] for k in keys}
    assert drill == {k: ref_anom[k] for k in keys}, (drill, ref_anom)
    assert drill["exchange_fallbacks"] > 0
    row = dict(epochs=epochs, plan="drop 5% seed 1",
               sites=int(tables.drop_np.sum()), **drill,
               launches=launches, loss=res.history["loss"][-1],
               val=res.final_metrics["val"],
               steps_worst_rel_vs_coo_f64=max(diffs), bar=STEP_REL)
    log(f"faults drills [{card}]: reddit-sim P=4 blocksparse/auto guarded "
        f"10 epochs, counters == COO f64's on the card: {json.dumps(row)}")
    return dict(tiny=cells, reddit=row)


def _wire_rows(model, topo, clean, faulted):
    """Rows of a step's fused forward and backward wires (captured sends,
    fault-free and faulted, from the same state) that the faults changed,
    that the receiver flags, and that it misses (changed, checksum
    intact); fails on a flagged row the faults did not change."""
    import torch
    codecs, pw = model.wire_codecs(topo), model.payload_widths(topo)
    L = len(codecs)
    counts = dict(changed_rows=0, flagged_rows=0, missed_rows=0)
    for layers, a, b in ((range(L), clean[0], faulted[0]),
                         (range(L - 1, 0, -1), clean[1], faulted[1])):
        lo = 0
        for ell in layers:
            hi = lo + codecs[ell].wire_width(pw[ell])
            x, y = a[..., lo:hi].contiguous(), b[..., lo:hi].contiguous()
            changed = (x.view(torch.uint8) != y.view(torch.uint8)).any(-1)
            valid = codecs[ell].decode_checked(y, pw[ell], x.dtype)[1]
            assert not (~valid & ~changed).any(), ell
            counts["changed_rows"] += int(changed.sum())
            counts["flagged_rows"] += int((~valid).sum())
            counts["missed_rows"] += int((changed & valid).sum())
            lo = hi
    return counts


def _faults_corrupt(reddit, card):
    """reddit-sim (blocksparse/auto, dropout 0, guarded) under a 2%
    background corrupt plan (density 0.02 per byte). Per step t, from the
    same state with and without the plan: every flagged (dst, direction,
    layer, src) site lies among the injected ones, and the rows the
    faults changed, the rows flagged and the rows missed (flips whose
    byte sum is unchanged mod 256: about 1 in 256 changed rows, decoding
    to garbage) are counted from the captured wires. Then 3 steps of the
    trainer's step (health guard on, as train_pipegcn runs it): params,
    Adam state and buffers stay finite; steps the health guard rolled
    back are counted."""
    import torch
    from repro_torch.core import HealthConfig, make_train_step
    from repro_torch.core.faults import FaultPlan
    from repro_torch.core.pipegcn import SimBackend
    from repro_torch.optim import adam
    model, lr = split_model(reddit, "blocksparse", dropout=0.0,
                            guard_exchange=True)
    topo, data = reddit.topo, reddit.train_data
    tables = FaultPlan(rate=0.02, rate_kind="corrupt", seed=7).compile(
        3, model.model.num_layers, topo.num_parts, device="cuda")
    params = model.init_params(torch.Generator(device="cuda").manual_seed(0))
    bufs0 = model.init_buffers(topo)
    rows = []
    for t in range(3):
        clean, faulted = _capture(SimBackend()), _capture(SimBackend())
        model.train_step(topo, params, bufs0, data, backend=clean)
        _, _, bufs, _ = model.train_step(topo, params, bufs0, data,
                                         backend=faulted, step_idx=t,
                                         faults=tables)
        flagged = bufs["es"].cpu().numpy() > 0          # (dst, d, L, src)
        injected = tables.corrupt_np[t].transpose(3, 0, 1, 2)
        assert not (flagged & ~injected).any(), t
        rows.append(dict(step=t, injected_sites=int(injected.sum()),
                         flagged_sites=int(flagged.sum()),
                         **_wire_rows(model, topo, clean.sent,
                                      faulted.sent)))
    assert sum(r["flagged_sites"] for r in rows) > 0
    opt = adam(lr)
    step = make_train_step(model, opt, HealthConfig())
    state = [params, opt.init(params), bufs0]
    skipped = 0
    for t in range(3):
        loss, *state, rep = step(topo, *state, data, None, t, tables)
        skipped += not bool(rep["ok"])
        for x in _leaves((state[0], state[1].mu, state[1].nu, state[2])):
            if x.is_floating_point():
                assert torch.isfinite(x).all(), f"trainer step {t}"
    out = dict(per_step=rows, trainer_steps=3, skipped_by_health_guard=skipped)
    log(f"faults corrupt [{card}]: reddit-sim P=4 2% corrupt plan, guarded: "
        f"flagged sites within the injected, trainer state finite: "
        f"{json.dumps(out)}")
    return out


def _faults_checkpoint(reddit, card):
    """reddit-sim blocksparse/auto at dropout 0.5 with the guard: 6 epochs
    == 3 epochs + resume, bitwise over the whole checkpointed state
    (params, Adam moments, buffers, es, the CUDA generator state); the
    checkpoint's bytes and its save and restore times."""
    import dataclasses
    import shutil
    import torch
    from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.core import PipeConfig, PipeGCN, train_pipegcn
    from repro_torch.optim import adam
    pipe = dataclasses.replace(PipeConfig.named("pipegcn"),
                               guard_exchange=True)
    mc, lr = _model_config(reddit, "blocksparse", "auto")
    assert mc.dropout == 0.5
    root = os.path.join(ROOT, "build", "chip_smoke_ckpt")
    shutil.rmtree(root, ignore_errors=True)
    kw = dict(lr=lr, seed=0, eval_every=EVAL_EVERY, device="cuda")
    try:
        full = train_pipegcn(reddit, mc, pipe, epochs=6,
                             ckpt_dir=os.path.join(root, "full"),
                             checkpoint_every=6, **kw)
        part = os.path.join(root, "part")
        train_pipegcn(reddit, mc, pipe, epochs=3, ckpt_dir=part,
                      checkpoint_every=3, **kw)
        res = train_pipegcn(reddit, mc, pipe, epochs=6, ckpt_dir=part,
                            checkpoint_every=3, resume=True, **kw)
        assert res.resumed_from == 3
        model = PipeGCN(mc, pipe)
        params = model.init_params(torch.Generator(device="cuda"))
        tmpl = {"params": params, "opt_state": adam(lr).init(params),
                "buffers": model.init_buffers(reddit.topo),
                "key": torch.Generator(device="cuda").get_state(),
                "epoch": 0}
        t0 = time.perf_counter()
        a = restore_checkpoint(os.path.join(root, "full"), 6, tmpl)
        torch.cuda.synchronize()
        restore_ms = (time.perf_counter() - t0) * 1e3
        b = restore_checkpoint(part, 6, tmpl)

        def tensors(s):
            return dict(params=s["params"], mu=s["opt_state"].mu,
                        nu=s["opt_state"].nu, buffers=s["buffers"],
                        key=s["key"])

        _bit_equal(tensors(a), tensors(b),
                   "resumed checkpoint vs uninterrupted")
        assert a["epoch"] == b["epoch"] == 6
        assert a["opt_state"].step == b["opt_state"].step == 6
        for k in full.params:
            assert torch.equal(full.params[k], res.params[k]), k
        assert res.history["loss"][-1] == full.history["loss"][-1]
        step_dir = os.path.join(part, "step_00000006")
        nbytes = sum(os.path.getsize(os.path.join(step_dir, f))
                     for f in os.listdir(step_dir))
        raw = sum(x.numel() * x.element_size() for x in _leaves(tensors(a)))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        save_checkpoint(os.path.join(root, "timed"), 6, a)
        save_ms = (time.perf_counter() - t0) * 1e3
    finally:
        shutil.rmtree(root, ignore_errors=True)
    row = dict(checkpoint_bytes=nbytes, state_bytes=raw, save_ms=save_ms,
               restore_ms=restore_ms, key_bytes=int(a["key"].numel()),
               loss=res.history["loss"][-1])
    log(f"faults checkpoint [{card}]: reddit-sim P=4 blocksparse/auto "
        f"dropout 0.5 guarded, 6 epochs == 3 + resume bitwise (params, "
        f"Adam moments, buffers, es, CUDA generator state): "
        f"{json.dumps(row)}")
    return row


def _faults_step_times(reddit, card):
    """reddit-sim blocksparse/auto train step (pipegcn, f32 wire) with the
    guard (and the trainer's host read of "es" after each step) and
    without: 2 warm-up steps, then 10 steps each in turns (g, u, u, g),
    medians of 20; one profiled step each for device launches and busy
    time."""
    import dataclasses
    import torch
    from repro_torch.core import (HealthConfig, PipeConfig, PipeGCN,
                                  make_train_step)
    from repro_torch.optim import adam
    state = {}
    for name, guard in (("guarded", True), ("unguarded", False)):
        mc, lr = _model_config(reddit, "blocksparse", "auto")
        model = PipeGCN(mc, dataclasses.replace(PipeConfig.named("pipegcn"),
                                                guard_exchange=guard))
        opt = adam(lr)
        params = model.init_params(
            torch.Generator(device="cuda").manual_seed(0))
        inner = make_train_step(model, opt, HealthConfig())

        def step(*a, inner=inner, guard=guard):
            out = inner(*a)
            if guard:
                out[3]["es"].cpu()      # the trainer's staleness check
            return out

        state[name] = (step, [
            reddit.topo, params, opt.init(params),
            model.init_buffers(reddit.topo), reddit.train_data,
            torch.Generator(device="cuda").manual_seed(1)])
        _timed_steps(*state[name], 2)
    times = {"guarded": [], "unguarded": []}
    for name in ("guarded", "unguarded", "unguarded", "guarded"):
        times[name] += _timed_steps(*state[name], 10)
    prof = {n: _device_kernels(lambda: _timed_steps(*state[n], 1))
            for n in times}
    out = {}
    for name, ts in times.items():
        q = sorted(ts)
        out[name] = dict(
            median=(q[9] + q[10]) / 2, q1=q[4], q3=q[14], max=q[-1],
            device_launches=sum(n for n, _ in prof[name].values()),
            device_busy_ms=sum(ms for _, ms in prof[name].values()))
    g, u = out["guarded"], out["unguarded"]
    # the device kernels the guard adds the most time to, by name
    extra = {k: (n - prof["unguarded"].get(k, (0, 0.0))[0],
                 ms - prof["unguarded"].get(k, (0, 0.0))[1])
             for k, (n, ms) in prof["guarded"].items()}
    out["guard"] = dict(step_ms=g["median"] - u["median"],
                        step_pct=100 * (g["median"] / u["median"] - 1),
                        launches=g["device_launches"] - u["device_launches"],
                        busy_ms=g["device_busy_ms"] - u["device_busy_ms"],
                        top_kernels=[[k[:70], n, ms] for k, (n, ms) in sorted(
                            extra.items(), key=lambda kv: -kv[1][1])[:8]])
    log(f"faults step times [{card}]: reddit-sim P=4 blocksparse/auto "
        f"train step ms (20 steps each, in turns g, u, u, g): "
        f"{json.dumps(out)}")
    return out


def phase_faults(reddit):
    """The guarded exchange and fault tolerance on the card: zero-fault
    identity with exact launches, the drills (BENCH_9.json's counts, the
    reddit-sim drill against COO f64), a corrupt plan, checkpoint /
    resume, and the guarded step's time."""
    t0 = time.perf_counter()
    card = nvidia_smi_line()
    out = dict(identity=_faults_identity(reddit, card),
               drills=_faults_drills(reddit, card),
               corrupt=_faults_corrupt(reddit, card),
               checkpoint=_faults_checkpoint(reddit, card),
               step_times=_faults_step_times(reddit, card))
    log(f"faults: phase took {time.perf_counter() - t0:.1f} s")
    return out


# ---------------------------------------------------------------------
# Phase "elastic": device loss, survivor remap, warm recovery and rejoin
# on the card
# ---------------------------------------------------------------------

ELASTIC_SURVIVORS = (0, 2, 3)   # device 1 of 4 lost: 3 survivors × 2, 2 pads
ELASTIC_EVERY = 4               # checkpoint every 4 epochs
ELASTIC_EPOCHS = 8


def _elastic_setup(reddit, agg="blocksparse", order="auto"):
    """reddit-sim's published model, the guarded pipegcn pipe
    (max_staleness 8), the plan losing device 1, and the model."""
    import dataclasses
    from repro_torch.core import ElasticPlan, PipeConfig, PipeGCN
    mc, lr = _model_config(reddit, agg, order)
    pipe = dataclasses.replace(PipeConfig.named("pipegcn"),
                               guard_exchange=True, max_staleness=8)
    plan = ElasticPlan(reddit.topo.num_parts, reddit.topo.num_parts,
                       ELASTIC_SURVIVORS)
    return mc, pipe, lr, plan, PipeGCN(mc, pipe, split=reddit.split_spec())


def _poison(numel: int) -> int:
    """Fill and free a NaN block the size of the next output and return
    its address: the caching allocator hands the block to the kernel's
    torch.empty output (the caller checks the address), so a row the
    kernel leaves unwritten reads NaN."""
    import torch
    return torch.full((numel,), float("nan"), device="cuda").data_ptr()


def _counters_clear() -> bool:
    """Every arrival, run and pass counter and the fused ticket are 0."""
    import torch
    from repro_torch.kernels import gcn_spmm
    ctr = gcn_spmm._WORKSPACE.get((torch.device("cuda", 0), torch.int32))
    return ctr is not None and not bool(ctr.any())


def _elastic_kernel_calls(topo, gen):
    """name -> (kernel call, plain call, output numel) at reddit-sim's
    main-path shapes: spmm / spmm_t F = 256, spmm_fused 128→256 with z and
    ReLU, spmm_fused_t 256←256; plus the fused call's bias and h."""
    import torch
    from repro_torch.kernels import gcn_spmm
    n, R = topo.num_parts, topo.max_inner
    C = R + topo.halo_size
    h = torch.randn(n, C, 256, device="cuda", generator=gen)
    h128 = torch.randn(n, C, 128, device="cuda", generator=gen)
    dz = torch.randn(n, R, 256, device="cuda", generator=gen)
    w1 = torch.randn(128, 256, device="cuda", generator=gen) * 0.1
    w2 = torch.randn(256, 256, device="cuda", generator=gen) * 0.1
    b = torch.randn(256, device="cuda", generator=gen)
    fwd = (topo.tile_work, topo.tile_items, topo.tile_rows, topo.tile_cols,
           topo.tile_vals)
    bwd = (topo.tile_t_work, topo.tile_t_items, topo.tile_t_out,
           topo.tile_t_in, topo.tile_t_perm, topo.tile_vals)
    calls = {
        "spmm": (lambda: gcn_spmm.spmm(*fwd, h, R),
                 lambda: gcn_spmm.spmm_plain(*fwd[2:], h, R), n * R * 256),
        "spmm_t": (lambda: gcn_spmm.spmm_t(*bwd, dz, C),
                   lambda: gcn_spmm.spmm_t_plain(*bwd[2:], dz, C),
                   n * C * 256),
        "spmm_fused": (
            lambda: gcn_spmm.spmm_fused(*fwd, h128, w1, b, R, relu=True),
            lambda: gcn_spmm.spmm_fused_plain(*fwd[2:], h128, w1, b, R,
                                              relu=True), n * R * 256),
        "spmm_fused_t": (
            lambda: gcn_spmm.spmm_fused_t(*bwd, dz, w2, C),
            lambda: gcn_spmm.spmm_fused_t_plain(*bwd[2:], dz, w2, C),
            n * C * 256)}
    z_of = lambda: gcn_spmm.spmm(*fwd, h128, R)   # noqa: E731
    return calls, b, z_of


def _elastic_kernels(reddit, card):
    """The four kernels of the padded survivor layout at reddit-sim's
    main-path shapes, each into a NaN-poisoned output: held against its
    plain version (spmm pair rtol = atol = 1e-5; fused pair
    gcn_spmm.assert_close_to_scale), every row finite, pad rows exact
    (z and δcomb 0, u ReLU(b)), the pads' halo rows of δcomb 0, the fused
    z bit-equal to spmm's, every workspace counter 0 after the launch;
    timed beside the same kernel on the original layout."""
    import torch
    from repro_torch.core.elastic import remap_topology
    from repro_torch.kernels import gcn_spmm
    *_, plan, _ = _elastic_setup(reddit)
    topo = remap_topology(reddit.topo, plan)
    P, R = plan.num_parts, topo.max_inner
    gen = torch.Generator(device="cuda").manual_seed(9)
    padded, b, z_of = _elastic_kernel_calls(topo, gen)
    flat, _, _ = _elastic_kernel_calls(reddit.topo, gen)
    rows = []
    for name, (kern, plain, numel) in padded.items():
        kern()                  # sizes the workspaces
        poisoned = _poison(numel)
        got = kern()
        torch.cuda.synchronize()
        out = got[0] if name == "spmm_fused" else got
        assert out.data_ptr() == poisoned, f"elastic {name}: not poisoned"
        assert _counters_clear(), f"elastic {name}: a counter left nonzero"
        want = plain()
        if name == "spmm_fused":
            assert torch.equal(got[1], z_of()), "elastic spmm_fused z"
            got, want = got[0], want[0]
        if name.startswith("spmm_fused"):
            err = gcn_spmm.assert_close_to_scale(got, want, f"elastic {name}")
        else:
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
            err = float((got - want).abs().max())
        assert torch.isfinite(got).all(), f"elastic {name}: unwritten rows"
        if name == "spmm_fused":
            assert torch.equal(got[P:], torch.relu(b).expand_as(got[P:]))
        else:
            assert not got[P:].any(), f"elastic {name}: pad rows"
        if name in ("spmm_t", "spmm_fused_t"):
            assert not got[:, R + P * topo.slot:].any(), \
                f"elastic {name}: the pads' halo rows"
        ms, ms_orig = _timed_pair(kern, flat[name][0])
        items = topo.tile_t_items if name.endswith("_t") else topo.tile_items
        rows.append(dict(name=name, max_abs_err=err, ms=ms,
                         ms_original_layout=ms_orig,
                         items=int((items[..., 0] >= 0).sum())))
    log(f"elastic kernels [{card}]: reddit-sim padded survivor layout "
        f"({topo.num_parts} partitions, {topo.num_parts - P} pads, survivors "
        f"{list(ELASTIC_SURVIVORS)}): every row written into NaN-poisoned "
        f"outputs, pads 0 / ReLU(b), counters 0: {json.dumps(rows)}")
    return rows


def _elastic_reference(reddit, faults, epochs, every, detect_after):
    """The device loss the COO engine in float64 on the card detects under
    `faults` (guarded steps, plain SGD between them): device, detection
    epoch, the checkpoint a trainer checkpointing every `every` epochs
    restores, and the survivors."""
    import torch
    from repro_torch.core.elastic import detect_device_loss
    model, _ = split_model(reddit, "coo", dropout=0.0, guard_exchange=True,
                           max_staleness=8)
    P = reddit.topo.num_parts
    tables = faults.compile(epochs, model.model.num_layers, P, device="cuda")
    topo, data = reddit.topo.to(torch.float64), _float64(reddit.train_data)
    params = {k: v.double() for k, v in model.init_params(
        torch.Generator(device="cuda").manual_seed(0)).items()}
    bufs = model.init_buffers(topo, dtype=torch.float64)
    for t in range(epochs):
        _, grads, bufs, _ = model.train_step(topo, params, bufs, data,
                                             step_idx=t, faults=tables)
        down = detect_device_loss(bufs["es"], 1, P, detect_after)
        if down is not None:
            return {"device": down, "detected_epoch": t,
                    "resumed_from": t // every * every,
                    "survivors": [d for d in range(P) if d != down]}
        params = {k: params[k] - 0.01 * grads[k] for k in params}
    return None


def _segments_launches(model, layouts, epochs, eval_at) -> dict:
    """Launches of a run whose steps ran on several layouts: `layouts` is
    [(topo, first epoch, end epoch)] in run order (replayed epochs
    counted again); evals at epochs `eval_at` on the layout in force."""
    total = dict.fromkeys(KERNELS, 0)
    for topo, lo, hi in layouts:
        evals = sum(lo <= e < hi for e in eval_at)
        for k, v in expected_launches(model, topo, hi - lo, evals).items():
            total[k] += v
    return total


def _elastic_run(reddit, agg, order, root, faults=None, plan=None,
                 resume=False, rejoin=False, epochs=ELASTIC_EPOCHS,
                 marks=None):
    """train_pipegcn on reddit-sim under the elastic runtime, with the
    launch counts zeroed just before and read just after."""
    from repro_torch.core import ElasticConfig, train_pipegcn
    mc, pipe, lr, _, _ = _elastic_setup(reddit, agg, order)

    def note(line):
        if marks is not None and line.startswith("device "):
            marks["remapped"] = time.perf_counter()
        log(f"elastic {agg}/{order}: {line}")

    reset_launches()
    res = train_pipegcn(reddit, mc, pipe, epochs=epochs, lr=lr, seed=0,
                        eval_every=EVAL_EVERY, device="cuda", faults=faults,
                        elastic=ElasticConfig(parts_per_device=1,
                                              rejoin=rejoin),
                        elastic_plan=plan, ckpt_dir=root,
                        checkpoint_every=ELASTIC_EVERY, resume=resume,
                        log=note)
    return res, read_launches()


def _recovery_marks():
    """Wrap the trainer's loss detector and step builder so that a run
    stamps when the loss is detected and when the first step after it
    ends (device synced). Returns (marks, undo)."""
    import torch
    from repro_torch.core import elastic, trainer
    marks = {}
    detect, make = elastic.detect_device_loss, trainer.make_train_step

    def detect_stamped(*a, **kw):
        down = detect(*a, **kw)
        if down is not None:
            marks.setdefault("detected", time.perf_counter())
        return down

    def make_stamped(*a, **kw):
        inner = make(*a, **kw)

        def step(*sa):
            out = inner(*sa)
            if "remapped" in marks and "first_step" not in marks:
                torch.cuda.synchronize()
                marks["first_step"] = time.perf_counter()
            return out
        return step

    elastic.detect_device_loss = detect_stamped
    trainer.make_train_step = make_stamped

    def undo():
        elastic.detect_device_loss = detect
        trainer.make_train_step = make
    return marks, undo


def _elastic_drills(reddit, card, root):
    """The drill (device 1 down at step 5, checkpoint every 4, 8 epochs)
    under blocksparse/auto and fused/aggregate-first with exact launches
    on both layouts; its device_losses equal the f64 COO run's; each
    recovery bitwise equal to a fresh survivor-layout launch from a copy
    of the same checkpoint; the wall time from detection to the first
    resumed step; then a rejoin drill (device 2 down for [3, 5), 10
    epochs)."""
    import shutil
    import torch
    from repro_torch.core import FaultPlan, device_down_site
    from repro_torch.core.elastic import remap_topology
    faults = FaultPlan(sites=(device_down_site(step=5, device=1),))
    runs, out = {}, {}
    for agg, order in (("blocksparse", "auto"), ("fused", "aggregate-first")):
        mc, pipe, _, plan, model = _elastic_setup(reddit, agg, order)
        topo_pad = remap_topology(reddit.topo, plan)
        d_a, d_b = (os.path.join(root, f"{agg}_{x}") for x in "ab")
        marks, undo = _recovery_marks()
        try:
            res, launches = _elastic_run(reddit, agg, order, d_a, faults,
                                         marks=marks)
        finally:
            undo()
        loss = res.anomalies["device_losses"]
        assert res.recoveries == 1 and len(loss) == 1, res.anomalies
        det, frm = loss[0]["detected_epoch"], loss[0]["resumed_from"]
        expect = _segments_launches(
            model, [(reddit.topo, 0, det + 1), (topo_pad, frm,
                                                ELASTIC_EPOCHS)],
            ELASTIC_EPOCHS, (0, ELASTIC_EPOCHS - 1))
        assert launches == expect, (agg, launches, expect)
        assert all(math.isfinite(v) for v in res.history["loss"])
        name = f"step_{frm:08d}"
        os.makedirs(d_b)
        shutil.copytree(os.path.join(d_a, name), os.path.join(d_b, name))
        fresh, _ = _elastic_run(reddit, agg, order, d_b, plan=plan,
                                resume=True)
        for k in res.params:
            assert torch.equal(res.params[k], fresh.params[k]), (agg, k)
        n = len(fresh.history["epoch"])
        assert res.history["loss"][-n:] == fresh.history["loss"], agg
        runs["reddit-sim P=4 elastic drill", agg, order] = dict(
            launches=launches)
        out[agg] = dict(device_losses=loss, launches=launches,
                        loss=res.history["loss"][-1],
                        val=res.final_metrics["val"],
                        bitwise_vs_fresh_launch=True,
                        detect_to_remapped_s=marks["remapped"]
                        - marks["detected"],
                        remapped_to_first_step_s=marks["first_step"]
                        - marks["remapped"],
                        detect_to_first_step_s=marks["first_step"]
                        - marks["detected"])
        log(f"elastic drill [{card}]: reddit-sim P=4 {agg}/{order}, device 1 "
            f"down at step 5: {json.dumps(out[agg])}")
    ref = _elastic_reference(reddit, faults, ELASTIC_EPOCHS, ELASTIC_EVERY, 2)
    for agg in out:
        assert out[agg]["device_losses"] == [ref], (agg, ref)
    loss = ref
    log(f"elastic drill [{card}]: device_losses == the COO float64 run's "
        f"on the card {json.dumps(ref)}; detection epoch "
        f"{loss['detected_epoch']}, replay window "
        f"{loss['detected_epoch'] - loss['resumed_from']} epochs")

    # rejoin: device 2 down for steps [3, 5)
    mc, pipe, _, plan, model = _elastic_setup(reddit)
    faults = FaultPlan(sites=(device_down_site(step=3, device=2, until=5),))
    res, launches = _elastic_run(reddit, "blocksparse", "auto",
                                 os.path.join(root, "rejoin"), faults,
                                 rejoin=True, epochs=10)
    assert res.recoveries == 1 and res.anomalies["rejoins"] == 1, \
        res.anomalies
    loss = res.anomalies["device_losses"][0]
    det, frm = loss["detected_epoch"], loss["resumed_from"]
    back = next(s for s in range(frm + ELASTIC_EVERY, 11, ELASTIC_EVERY)
                if s >= 5)
    plan2 = type(plan)(4, 4, loss["survivors"])
    expect = _segments_launches(
        model, [(reddit.topo, 0, det + 1),
                (remap_topology(reddit.topo, plan2), frm, back),
                (reddit.topo, back, 10)], 10, (0, 9))
    assert launches == expect, ("rejoin", launches, expect)
    runs["reddit-sim P=4 elastic rejoin", "blocksparse", "auto"] = dict(
        launches=launches)
    out["rejoin"] = dict(device_losses=[loss], rejoins=1, rejoined_at=back,
                         launches=launches, loss=res.history["loss"][-1],
                         val=res.final_metrics["val"])
    log(f"elastic rejoin [{card}]: reddit-sim P=4 blocksparse/auto, device "
        f"2 down for steps [3, 5): {json.dumps(out['rejoin'])}")
    return out, runs


def _elastic_steps(reddit, card):
    """The padded layout's guarded step (blocksparse/auto): 2 steps at
    dropout 0 from warm-marked remapped zero buffers with exact launches,
    every buffer
    finite, the pads' es 0 and their logits rows one finite row; then the
    survivor-layout step against the original layout's in turns (o, s, s,
    o; medians of 20), one profiled step each for device launches and
    busy, the exchanges per padded step (RecordingBackend), and the
    buffers' bytes on both layouts."""
    import torch
    from repro_torch.core import HealthConfig, make_train_step
    from repro_torch.core.elastic import (remap_buffers, remap_data,
                                          remap_topology, warm_mark)
    from repro_torch.core.pipegcn import SimBackend
    from repro_torch.core.trace_utils import RecordingBackend
    from repro_torch.optim import adam
    import dataclasses
    from repro_torch.core import PipeGCN
    mc, pipe, lr, plan, model = _elastic_setup(reddit)
    P = plan.num_parts
    topo = remap_topology(reddit.topo, plan)
    data = remap_data(reddit.train_data, plan)
    params = model.init_params(torch.Generator(device="cuda").manual_seed(0))
    flat = model.init_buffers(reddit.topo)
    bufs = warm_mark(remap_buffers(flat, plan), plan.moved_partitions(), 1, P)
    # dropout 0: every pad row then sees the same (zero) inputs
    model0 = PipeGCN(dataclasses.replace(mc, dropout=0.0), pipe)
    reset_launches()
    rec = RecordingBackend(SimBackend())
    b = bufs
    for _ in range(2):
        loss, grads, b, logits = model0.train_step(topo, params, b, data,
                                                   backend=rec)
    launches = read_launches()
    assert launches == expected_launches(model0, topo, 2, 0), launches
    for x in _leaves(b):
        if x.is_floating_point():
            assert torch.isfinite(x).all(), "padded step: non-finite buffer"
    es = b["es"]
    assert not es[P:].any() and not es[..., P:].any(), "pads' es"
    pad = logits[P:].reshape(-1, logits.shape[-1])
    assert torch.isfinite(pad).all() and torch.equal(
        pad, pad[:1].expand_as(pad)), "pad logits rows"
    exchanges = rec.events.count("exchange") // 2

    def nbytes(tree):
        return sum(x.numel() * x.element_size() for x in _leaves(tree))

    opt = adam(lr)
    state = {}
    for name, t, d, bb in (("original", reddit.topo, reddit.train_data,
                            flat), ("survivor", topo, data, bufs)):
        inner = make_train_step(model, opt, HealthConfig())

        def step(*a, inner=inner):
            out = inner(*a)
            out[3]["es"].cpu()      # the trainer's staleness check
            return out

        state[name] = (step, [t, params, opt.init(params), bb, d,
                              torch.Generator(device="cuda").manual_seed(1)])
        _timed_steps(*state[name], 2)
    times = {"original": [], "survivor": []}
    for name in ("original", "survivor", "survivor", "original"):
        times[name] += _timed_steps(*state[name], 10)
    prof = {n: _device_launches(*state[n]) for n in times}
    out = {}
    for name, ts in times.items():
        q = sorted(ts)
        out[name] = dict(median=(q[9] + q[10]) / 2, q1=q[4], q3=q[14],
                         max=q[-1], device_launches=prof[name][0],
                         device_busy_ms=prof[name][1])
    out["survivor_over_original"] = (out["survivor"]["median"]
                                     / out["original"]["median"])
    out["buffer_bytes"] = dict(original=nbytes(flat), survivor=nbytes(bufs))
    out["exchanges_per_step"] = exchanges
    out["padded_step_launches"] = launches
    log(f"elastic steps [{card}]: reddit-sim P=4 blocksparse/auto guarded "
        f"train step ms, original vs survivor layout (20 steps each, in "
        f"turns o, s, s, o; pads es 0, exact launches): {json.dumps(out)}")
    return out


def phase_elastic(reddit):
    """The elastic runtime on the card: the padded layout's kernels, the
    drills (exact launches, f64 COO device losses, recovery == fresh
    survivor launch bitwise, recovery wall time, rejoin), the padded step
    and its time against the original layout's. Returns the drills' runs
    for the kernels line's launch counts."""
    import shutil
    t0 = time.perf_counter()
    card = nvidia_smi_line()
    root = os.path.join(ROOT, "build", "chip_smoke_elastic")
    shutil.rmtree(root, ignore_errors=True)
    try:
        kernels = _elastic_kernels(reddit, card)
        drills, runs = _elastic_drills(reddit, card, root)
        steps = _elastic_steps(reddit, card)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(f"elastic: phase took {time.perf_counter() - t0:.1f} s")
    return dict(kernels=kernels, drills=drills, steps=steps), runs


# ---------------------------------------------------------------------
# The GCN-side API slice: the ops entry points, make_pipegcn_loss, the
# optimizer family, the schedule preflight and the examples
# ---------------------------------------------------------------------

def _api_ops(reddit, yelp2, card):
    """The six ops entry points on partition 0's tile arrays, each called
    once with the launch counts zeroed before and read after (one launch
    per call, two per phased pair): reddit-sim P=4 spmm / spmm_t at F =
    256, spmm_fused 128->256 with z, spmm_fused_t 256<-256; yelp-sim P=2
    spmm_phased / spmm_t_phased at F = 512, both phases. Each against its
    plain version at 1e-5 (the fused pair to scale), and bitwise against
    partition 0 of the stacked wrapper's launch (reported); the host ms
    of building each call's schedule."""
    import torch
    from repro_torch.kernels import gcn_spmm, ops
    gen = torch.Generator(device="cuda").manual_seed(3)
    topo = reddit.topo
    P, R = topo.num_parts, topo.max_inner
    C = R + topo.halo_size
    fwd = (topo.tile_rows, topo.tile_cols, topo.tile_vals)
    bwd = (topo.tile_t_out, topo.tile_t_in, topo.tile_t_perm, topo.tile_vals)
    fwd0, bwd0 = [a[0] for a in fwd], [a[0] for a in bwd]
    x = {"h": torch.randn(P, C, 256, device="cuda", generator=gen),
         "dz": torch.randn(P, R, 256, device="cuda", generator=gen),
         "hf": torch.randn(P, C, 128, device="cuda", generator=gen),
         "du": torch.randn(P, R, 256, device="cuda", generator=gen)}
    w = torch.randn(128, 256, device="cuda", generator=gen) / 128 ** 0.5
    b = torch.randn(256, device="cuda", generator=gen)
    wt = torch.randn(256, 256, device="cuda", generator=gen) / 16.0
    y = yelp2.topo
    sp = yelp2.split_spec()
    yR, yC = y.max_inner, y.max_inner + y.halo_size
    yfwd = (y.tile_rows, y.tile_cols, y.tile_vals)
    ybwd = (y.tile_t_out, y.tile_t_in, y.tile_t_perm, y.tile_vals)
    yfwd0, ybwd0 = [a[0] for a in yfwd], [a[0] for a in ybwd]
    yh = torch.randn(2, yC, 512, device="cuda", generator=gen)
    ydz = torch.randn(2, yR, 512, device="cuda", generator=gen)
    assert ops._split(yfwd0[0], sp.fwd_bnd_tiles).row_tail == sp.row_tail
    assert ops._split(ybwd0[0], sp.t_bnd_tiles).col_tail == sp.col_tail
    calls = {   # name -> the entry point's call
        "spmm": lambda: ops.spmm(*fwd0, x["h"][0], R),
        "spmm_t": lambda: ops.spmm_t(*bwd0, x["dz"][0], C),
        "spmm_fused": lambda: ops.spmm_fused(*fwd0, x["hf"][0], w, b[None],
                                             R, relu=False, with_z=True),
        "spmm_fused_t": lambda: ops.spmm_fused_t(*bwd0, x["du"][0], wt, C),
        "spmm_phased": lambda: [ops.spmm_phased(*yfwd0, yh[0], yR,
                                                sp.fwd_bnd_tiles, ph)
                                for ph in ("boundary", "interior")],
        "spmm_t_phased": lambda: [ops.spmm_t_phased(*ybwd0, ydz[0], yC,
                                                    sp.t_bnd_tiles, ph)
                                  for ph in ("boundary", "interior")],
    }
    reset_launches()
    got = {k: fn() for k, fn in calls.items()}
    torch.cuda.synchronize()
    launches = read_launches()
    want_launches = dict.fromkeys(KERNELS, 1)
    want_launches.update(spmm_phased=2, spmm_t_phased=2, flash_attention=0)
    assert launches == want_launches, launches
    # the plain versions and the stacked launches on the same inputs
    sched = (topo.tile_work, topo.tile_items)
    t_sched = (topo.tile_t_work, topo.tile_t_items)
    ysched, yt_sched = (y.tile_work, y.tile_items), (y.tile_t_work,
                                                     y.tile_t_items)
    one = lambda arrs: [a[:1] for a in arrs]            # noqa: E731
    plain = {
        "spmm": gcn_spmm.spmm_plain(*one(fwd), x["h"][:1], R)[0],
        "spmm_t": gcn_spmm.spmm_t_plain(*one(bwd), x["dz"][:1], C)[0],
        "spmm_fused": [t[0] for t in gcn_spmm.spmm_fused_plain(
            *one(fwd), x["hf"][:1], w, b, R)],
        "spmm_fused_t": gcn_spmm.spmm_fused_t_plain(
            *one(bwd), x["du"][:1], wt, C)[0],
        "spmm_phased": [gcn_spmm.spmm_phased_plain(
            *one(yfwd), yh[:1], yR, sp, ph)[0]
            for ph in ("boundary", "interior")],
        "spmm_t_phased": [gcn_spmm.spmm_t_phased_plain(
            *one(ybwd), ydz[:1], yC, sp, ph)[0]
            for ph in ("boundary", "interior")],
    }
    stacked = {
        "spmm": gcn_spmm.spmm(*sched, *fwd, x["h"], R)[0],
        "spmm_t": gcn_spmm.spmm_t(*t_sched, *bwd, x["dz"], C)[0],
        "spmm_fused": [t[0] for t in gcn_spmm.spmm_fused(
            *sched, *fwd, x["hf"], w, b, R)],
        "spmm_fused_t": gcn_spmm.spmm_fused_t(*t_sched, *bwd, x["du"], wt,
                                              C)[0],
        "spmm_phased": [gcn_spmm.spmm_phased(*ysched, *yfwd, yh, yR, sp,
                                             ph)[0]
                        for ph in ("boundary", "interior")],
        "spmm_t_phased": [gcn_spmm.spmm_t_phased(*yt_sched, *ybwd, ydz, yC,
                                                 sp, ph)[0]
                          for ph in ("boundary", "interior")],
    }
    builders = {
        "spmm": lambda: ops.forward_schedule(*fwd0, R),
        "spmm_t": lambda: ops.transpose_schedule(*bwd0, C),
        "spmm_fused": lambda: ops.forward_schedule(*fwd0, R),
        "spmm_fused_t": lambda: ops.transpose_schedule(*bwd0, C),
        "spmm_phased": lambda: ops.forward_schedule(*yfwd0, yR),
        "spmm_t_phased": lambda: ops.transpose_schedule(*ybwd0, yC),
    }
    owned = {"spmm_phased": [(sp.row_tail, yR), (0, sp.row_tail)],
             "spmm_t_phased": [(sp.col_tail, yC), (0, sp.col_tail)]}
    rows = {}
    for name in calls:
        g, pl, st = got[name], plain[name], stacked[name]
        if name in owned:    # a phase's own rows
            g, pl, st = ([t[lo:hi] for t, (lo, hi) in zip(v, owned[name])]
                         for v in (g, pl, st))
        g, pl, st = ([t] if torch.is_tensor(t) else t for t in (g, pl, st))
        for i, (a, c) in enumerate(zip(g, pl)):
            if name.startswith("spmm_fused") and i == 0:
                gcn_spmm.assert_close_to_scale(a, c, f"ops.{name}")
            else:
                torch.testing.assert_close(a, c, rtol=1e-5, atol=1e-5)
        err = max(float((a - c).abs().max()) for a, c in zip(g, pl))
        same = all(torch.equal(a, c) for a, c in zip(g, st))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        builders[name]()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        rows[name] = dict(max_abs_err=err, bitwise_vs_stacked=same,
                          schedule_host_ms=ms)
        log(f"api ops [{card}]: ops.{name} max_abs_err vs plain {err:.3g}, "
            f"{'bitwise equal to' if same else 'DIFFERS from'} partition 0 "
            f"of the stacked launch; schedule built in {ms:.2f} host ms")
    return rows, launches


def _api_loss(reddit, card):
    """make_pipegcn_loss on reddit-sim P=4 at full width (hidden 256, 4
    layers, dropout 0.5 with matched generators), blocksparse/auto and
    fused/auto, 2 steps: loss, gradients and buffers bitwise equal to
    train_step's, the gradient of 3·loss bitwise 3× the gradient, and
    each step's launches equal to train_step's and to expected_launches.
    Returns the runs' launch counts."""
    import torch
    from repro_torch.core import PipeConfig, PipeGCN, make_pipegcn_loss
    topo, data = reddit.topo, reddit.train_data
    runs, out = {}, {}
    for agg in ("blocksparse", "fused"):
        mc, lr = _model_config(reddit, agg, "auto")
        model = PipeGCN(mc, PipeConfig.named("pipegcn"))
        loss_fn = make_pipegcn_loss(model, topo)
        params = model.init_params(
            torch.Generator(device="cuda").manual_seed(0))
        b_ref = b_api = model.init_buffers(topo)
        g_ref, g_api, g_3 = (torch.Generator(device="cuda").manual_seed(1)
                             for _ in range(3))
        want = expected_launches(model, topo, 1, 0)
        total = dict.fromkeys(KERNELS, 0)
        for t in range(2):
            b_in = b_api
            reset_launches()
            l0, gr0, b_ref, _ = model.train_step(topo, params, b_ref, data,
                                                 g_ref)
            torch.cuda.synchronize()
            ref_launches = read_launches()
            leaves = {k: v.detach().requires_grad_()
                      for k, v in params.items()}
            reset_launches()
            loss, b_api = loss_fn(leaves, b_in, data, g_api)
            loss.backward()
            torch.cuda.synchronize()
            api_launches = read_launches()
            assert api_launches == ref_launches == want, (
                agg, t, api_launches, ref_launches, want)
            for k, v in api_launches.items():
                total[k] += v
            _bit_equal((loss.detach(), {k: v.grad for k, v in leaves.items()},
                        b_api), (l0, gr0, b_ref), f"api loss {agg} step {t}")
            assert not any(x.requires_grad for x in _leaves(b_api))
            leaves3 = {k: v.detach().requires_grad_()
                       for k, v in params.items()}
            loss3, _ = loss_fn(leaves3, b_in, data, g_3)
            (3 * loss3).backward()
            for k in gr0:
                assert torch.equal(leaves3[k].grad, 3 * gr0[k]), (agg, t, k)
            params = {k: params[k] - lr * gr0[k] for k in params}
        log(f"api loss [{card}]: make_pipegcn_loss reddit-sim P=4 {agg}/auto "
            f"(hidden 256, 4 layers, dropout 0.5): 2 steps, loss "
            f"{float(l0):.6f}, loss / gradients / buffers bitwise equal to "
            f"train_step's, grad of 3·loss == 3·grad bitwise, launches per "
            f"step {want} (== train_step's)")
        runs["api make_pipegcn_loss reddit-sim P=4", agg, "auto"] = dict(
            launches=total)
        out[agg] = dict(loss=float(l0), launches_per_step=want)
    return out, runs


def _api_optim(reddit, card):
    """adamw under linear_warmup_cosine with max_grad_norm, 5 steps on the
    reddit-sim parameters (full width) with the main path's gradients,
    against the same optimizer run on the CPU from the same parameters and
    gradients: parameters and both moments within 1e-6 relative norm."""
    import torch
    from repro_torch.core import PipeConfig, PipeGCN
    from repro_torch.optim import adamw, linear_warmup_cosine
    mc, lr = _model_config(reddit, "blocksparse", "auto")
    model = PipeGCN(mc, PipeConfig.named("pipegcn"))
    opt = adamw(linear_warmup_cosine(lr, 2, 5), weight_decay=0.01,
                max_grad_norm=1.0)
    params = model.init_params(torch.Generator(device="cuda").manual_seed(0))
    card_p, card_s = params, opt.init(params)
    cpu_p = {k: v.cpu() for k, v in params.items()}
    cpu_s = opt.init(cpu_p)
    bufs = model.init_buffers(reddit.topo)
    gen = torch.Generator(device="cuda").manual_seed(1)
    worst = 0.0
    for t in range(5):
        _, grads, bufs, _ = model.train_step(reddit.topo, card_p, bufs,
                                             reddit.train_data, gen)
        card_p, card_s = opt.apply(card_p, grads, card_s)
        cpu_p, cpu_s = opt.apply(cpu_p, {k: g.cpu() for k, g in grads.items()},
                                 cpu_s)
        for tree_card, tree_cpu, what in ((card_p, cpu_p, "param"),
                                          (card_s.mu, cpu_s.mu, "mu"),
                                          (card_s.nu, cpu_s.nu, "nu")):
            for k in tree_cpu:
                worst = max(worst, _rel_close(tree_card[k].cpu(),
                                              tree_cpu[k],
                                              f"adamw {what} {k} step {t}",
                                              rel=1e-6))
    log(f"api optim [{card}]: adamw(linear_warmup_cosine(lr, 2, 5), "
        f"weight_decay 0.01, max_grad_norm 1.0) 5 steps on reddit-sim's "
        f"parameters: card vs CPU worst relative norm {worst:.3g} (<= 1e-6)")
    return dict(worst_rel=worst)


def _api_examples(card):
    """The schedule preflight's five cells on the card (sim backend, and
    one NCCL rank holding the 4 partitions), and the quickstart and
    stale-halo examples for a few epochs."""
    import importlib.util
    import math
    from repro_torch.launch import check_schedule
    t0 = time.perf_counter()
    n = check_schedule.check_cells(check_schedule._pipeline("cuda"),
                                   log=lambda s: log(f"api schedule: {s}"))
    n += check_schedule.check_spmd("cuda")
    log(f"api schedule [{card}]: check_schedule {n} cells (sim + NCCL) OK "
        f"in {time.perf_counter() - t0:.2f} s")

    def example(name):
        spec = importlib.util.spec_from_file_location(
            name, os.path.join(ROOT, "examples", f"{name}.py"))
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module
    out = {}
    t0 = time.perf_counter()
    res = example("torch_quickstart").main(epochs=3, device="cuda")
    losses = {k: r.history["loss"][-1] for k, r in res.items()}
    assert all(math.isfinite(v) for v in losses.values()), losses
    out["quickstart_s"] = time.perf_counter() - t0
    log(f"api examples [{card}]: torch_quickstart 3 epochs x 3 variants, "
        f"final losses {losses}, {out['quickstart_s']:.2f} s")
    t0 = time.perf_counter()
    res = example("torch_stale_halo_transformer").main(steps=20,
                                                       device="cuda")
    assert all(math.isfinite(v[-1]) for v in res.values()), res
    out["halo_s"] = time.perf_counter() - t0
    log(f"api examples [{card}]: torch_stale_halo_transformer 20 steps x 3 "
        f"modes, final losses { {k: v[-1] for k, v in res.items()} }, "
        f"{out['halo_s']:.2f} s")
    return out


def phase_api(reddit, split_pipes):
    """The GCN-side API on the card: the ops entry points, make_pipegcn_loss,
    the optimizer family, the schedule preflight and two examples. Returns
    the runs' launch counts for the kernels line."""
    t0 = time.perf_counter()
    card = nvidia_smi_line()
    ops_rows, ops_launches = _api_ops(reddit, split_pipes[0], card)
    loss, runs = _api_loss(reddit, card)
    runs["api ops", "partition 0", "reddit-sim P=4 / yelp-sim P=2"] = dict(
        launches=ops_launches)
    optim = _api_optim(reddit, card)
    examples = _api_examples(card)
    log(f"api [{card}]: " + json.dumps(dict(ops=ops_rows, loss=loss,
                                            optim=optim, examples=examples)))
    log(f"api: phase took {time.perf_counter() - t0:.1f} s")
    return runs


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


# ---------------------------------------------------------------------
# The LM zoo's serve path: qwen3-8b at full width and depth, and the ten
# reduced archs card against CPU
# ---------------------------------------------------------------------

SERVE_ARCH = "qwen3-8b"
SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = 4, 64, 32
SERVE_PREFILL_TOL = 2e-4       # tests/test_models_decode.py's bars
SERVE_DECODE_TOL = 3e-3        # of the max-abs logit
SERVE_BF16_TOL = 5e-2          # bf16 decode vs bf16 forward, of max-abs
SERVE_CARD_CPU_REL = 1e-4      # reduced archs: card vs CPU, relative norm
SERVE_REDUCED_STEPS = 4
SERVE_LONG, SERVE_LONG_STEPS = 32768, 6    # qwen3-8b's context length
# the other mixers at their published widths, in f32: (arch, layers kept
# or None for all, batch, prompt, decode steps)
SERVE_MIXERS = (
    ("mamba2-780m", None, 2, 300, 8),           # SSD: 2 chunks of 256
    ("recurrentgemma-2b", None, 2, 64, 8),      # RG-LRU, local MQA
    ("granite-moe-1b-a400m", None, 4, 64, 8),   # MoE: 32 experts, top-8
    ("whisper-large-v3", None, 2, 64, 8),       # enc-dec, 1500 frames
    ("deepseek-v2-236b", 3, 2, 64, 8),          # MLA, 160 experts
    ("llama-3.2-vision-11b", 10, 2, 64, 8),     # gated cross-attention
)


def _tree_bytes(tree) -> int:
    from torch.utils._pytree import tree_leaves
    return sum(x.numel() * x.element_size() for x in tree_leaves(tree))


def _cast_(tree, dtype):
    """Cast every leaf of a dict / list tree to `dtype` in place, leaf by
    leaf, so each f32 leaf is freed as its bf16 copy is made."""
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in list(items):
        if isinstance(v, (dict, list)):
            _cast_(v, dtype)
        else:
            tree[k] = v.to(dtype)
            del v


def _memory_inputs(cfg, b: int, seed: int) -> dict:
    """numpy-seeded audio frames (enc-dec) or image tokens (VLM) on the
    card, f32, where the arch reads them."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    out = {}
    if cfg.is_encdec:
        out["audio_embed"] = rng.standard_normal(
            (b, cfg.num_audio_frames, cfg.d_model))
    if cfg.num_image_tokens:
        out["image_embed"] = rng.standard_normal(
            (b, cfg.num_image_tokens, cfg.d_model))
    return {k: torch.from_numpy(v).float().cuda() for k, v in out.items()}


def _greedy_run(lm, params, batch, gen: int):
    """Prefill `batch` (tokens (B, S) and any memory) into caches the run
    owns, so donated as serve_with donates them, and decode greedily for
    `gen` steps: (prefill's last logits, [logits of each step], [fed
    tokens])."""
    import torch
    tokens = batch["tokens"]
    caches = lm.init_caches(tokens.shape[0], tokens.shape[1] + gen,
                            tokens.device)
    last, caches = lm.prefill(params, batch, caches, donate=True)
    logits, fed, out = last, [], []
    for i in range(gen):
        tok = torch.argmax(logits[:, -1], dim=-1, keepdim=True)
        fed.append(tok)
        logits, caches = lm.decode_step(params, tok, caches,
                                        tokens.shape[1] + i, donate=True)
        out.append(logits)
    return last, out, fed


def _forward_last(lm, params, batch):
    return lm.forward_logits(params, batch, moe_dropless=True)[0][:, -1]


def _scaled_err(got, want, vocab: int) -> float:
    got, want = got[..., :vocab].float(), want[..., :vocab].float()
    return float((got - want).abs().max() / (want.abs().max() + 1e-9))


def _decode_checks(lm, params, batch, out, fed, tol, what, card):
    """The logits of the first, middle and last decode step against
    forward_logits on the prompt plus the tokens fed so far, as a share of
    the max-abs logit."""
    import torch
    errs = {}
    n = len(out)
    for i in sorted({0, n // 2 - 1, n - 1}):
        seq = torch.cat([batch["tokens"]] + fed[:i + 1], dim=1)
        full = _forward_last(lm, params, dict(batch, tokens=seq))
        got = out[i][:, 0]
        assert bool(torch.isfinite(got[..., :lm.cfg.vocab_size]).all()), (
            what, i)
        errs[i] = _scaled_err(got, full, lm.cfg.vocab_size)
        assert errs[i] < tol, (what, i, errs[i], tol)
    log(f"serve {what} [{card}]: decode logits vs forward_logits at steps "
        f"{list(errs)}: max-abs-scaled err "
        f"{ {k: f'{v:.3e}' for k, v in errs.items()} } (bar {tol}) OK")
    return errs


def _f32_checks(lm, params, batch, gen: int, what, card):
    """A greedy prefill + `gen` decode steps, then prefill's last logits
    against forward_logits on the prompt (atol = rtol = SERVE_PREFILL_TOL)
    and the checked steps' logits (SERVE_DECODE_TOL of the max-abs logit):
    (last, out, fed, seconds of the greedy run, the errors)."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    last, out, fed = _greedy_run(lm, params, batch, gen)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    full = _forward_last(lm, params, batch)
    v = lm.cfg.vocab_size
    err = float((last[:, 0, :v] - full[:, :v]).abs().max())
    torch.testing.assert_close(last[:, 0, :v], full[:, :v],
                               atol=SERVE_PREFILL_TOL, rtol=SERVE_PREFILL_TOL)
    log(f"serve {what} [{card}]: prefill last logits vs forward_logits: "
        f"max abs err {err:.3e} (atol = rtol = {SERVE_PREFILL_TOL}) OK")
    errs = _decode_checks(lm, params, batch, out, fed, SERVE_DECODE_TOL,
                          what, card)
    return last, out, fed, secs, dict(prefill_abs_err=err, decode_errs=errs)


def _step_stats(kernels: dict) -> dict:
    """A _device_kernels map summed: kernels and copies (counts), device
    busy ms and the ten most launched."""
    copies = sum(n for k, (n, _) in kernels.items()
                 if k.startswith(("Memcpy", "Memset")))
    top = sorted(((k[:60], n) for k, (n, _) in kernels.items()),
                 key=lambda kv: -kv[1])[:10]
    return dict(kernels=sum(n for n, _ in kernels.values()) - copies,
                copies=copies, top=top,
                busy_ms=sum(ms for _, ms in kernels.values()))


def _step_bytes(lm, params, caches, batch: int) -> int:
    """The bytes a decode step must move: every weight but the embedding
    table, its `batch` rows, every cache byte once, the logits."""
    table = params["embed"]["table"]
    return (_tree_bytes(params) - table.numel() * table.element_size()
            + batch * lm.cfg.d_model * table.element_size()
            + _tree_bytes(caches)
            + batch * lm.cfg.padded_vocab * table.element_size())


def _decode_long(lm, params, prompts, card):
    """bf16 decode steps against caches of SERVE_LONG slots (qwen3-8b's
    context; the step attends over every slot, as JAX's does), the caches
    donated (serve_with) and copied (the default) in turns: ms per step,
    one profiled step each, the peak memory over what was allocated
    before, and the bound (a copy moves the cache twice more)."""
    import torch
    b, s = prompts.shape
    times = {"donated": [], "copied": []}
    prof, peak = {}, {}
    base = torch.cuda.memory_allocated()
    for name in ("donated", "copied", "copied", "donated"):
        donate = name == "donated"
        torch.cuda.reset_peak_memory_stats()
        caches = lm.init_caches(b, SERVE_LONG, "cuda")
        _, caches = lm.prefill(params, {"tokens": prompts}, caches,
                               donate=True)
        tok = prompts[:, -1:]
        for i in range(SERVE_LONG_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, caches = lm.decode_step(params, tok, caches, s + i,
                                       donate=donate)
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t0) * 1e3)
        if name not in prof:
            prof[name] = _step_stats(_device_kernels(
                lambda: lm.decode_step(params, tok, caches,
                                       s + SERVE_LONG_STEPS, donate=donate)))
        peak[name] = max(peak.get(name, 0),
                         torch.cuda.max_memory_allocated() - base)
        cache_bytes = _tree_bytes(caches)
        step_bytes = _step_bytes(lm, params, caches, b)
        del caches
    out = {}
    for name, ts in times.items():
        q = sorted(ts[1:SERVE_LONG_STEPS] + ts[SERVE_LONG_STEPS + 1:])
        moved = step_bytes + (2 * cache_bytes if name == "copied" else 0)
        out[name] = dict(median_ms=(q[len(q) // 2 - 1] + q[len(q) // 2]) / 2,
                         min_ms=q[0], max_ms=q[-1],
                         bound_ms=moved / PEAK_BYTES * 1e3,
                         busy_ms=prof[name]["busy_ms"],
                         kernels=prof[name]["kernels"],
                         copies=prof[name]["copies"],
                         peak_over_weights_gb=peak[name] / 1e9)
    out["cache_gb"] = cache_bytes / 1e9
    log(f"serve bf16 long cache [{card}]: {SERVE_ARCH} batch {b}, "
        f"{SERVE_LONG} cache slots ({cache_bytes / 1e9:.3f} GB of KV), "
        f"{SERVE_LONG_STEPS} steps x 2 each (the first of each run not "
        f"counted): {json.dumps(out)}")
    return out


def _serve_full(card):
    """qwen3-8b at full width and depth: f32 checks, then the same weights
    in bf16 through serve_with with its times, launches and bound, and the
    decode step at the model's context length."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from torch.utils._pytree import tree_leaves
    from repro_torch.launch.serve import serve_with
    from repro_torch.models.model import LM
    cfg = get_arch(SERVE_ARCH)
    lm32 = LM(dataclasses.replace(cfg, dtype="float32"))
    max_len = SERVE_PROMPT + SERVE_GEN
    t0 = time.perf_counter()
    params = lm32.init_params(torch.Generator("cuda").manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(x.numel() for x in tree_leaves(params))
    log(f"serve f32 [{card}]: {SERVE_ARCH} full width, {cfg.num_layers} "
        f"layers, {n_params:,} parameters ({_tree_bytes(params) / 1e9:.2f} "
        f"GB f32) drawn on the card in {time.perf_counter() - t0:.2f} s")
    prompts = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT))).cuda()
    with torch.inference_mode():
        last, out, fed, f32_s, _ = _f32_checks(
            lm32, params, {"tokens": prompts}, SERVE_GEN, "f32", card)
        prefill_ms = cuda_time_ms(lambda: lm32.prefill(
            params, {"tokens": prompts},
            lm32.init_caches(SERVE_BATCH, max_len, "cuda"), donate=True), 2)
    flops = 2 * n_params * SERVE_BATCH * SERVE_PROMPT
    log(f"serve f32 [{card}]: prefill {SERVE_BATCH}x{SERVE_PROMPT} "
        f"{prefill_ms:.3f} ms ({flops / prefill_ms / 1e9:.1f} TFLOP/s at "
        f"2·params·tokens = {flops / 1e12:.2f} TFLOP; TF32 off), greedy "
        f"prefill + {SERVE_GEN} steps {f32_s:.3f} s, tokens[0] "
        f"{torch.cat(fed, 1)[0, :8].tolist()}")
    del last, out

    _cast_(params, torch.bfloat16)
    torch.cuda.empty_cache()
    lm16 = LM(cfg)
    assert lm16.dtype == torch.bfloat16
    weight_bytes = _tree_bytes(params)
    base = torch.cuda.memory_allocated()
    serve_with(lm16, params, SERVE_BATCH, SERVE_PROMPT, 4)     # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    res = serve_with(lm16, params, SERVE_BATCH, SERVE_PROMPT, SERVE_GEN)
    peak = torch.cuda.max_memory_allocated()
    with torch.inference_mode():
        _, out, fed = _greedy_run(lm16, params, {"tokens": prompts},
                                  SERVE_GEN)
        tokens = torch.cat(fed, 1)
        assert tokens[0, :8].tolist() == res["sample_output"], (
            tokens[0, :8].tolist(), res["sample_output"])
        errs = _decode_checks(lm16, params, {"tokens": prompts}, out, fed,
                              SERVE_BF16_TOL, "bf16", card)
        caches = lm16.init_caches(SERVE_BATCH, max_len, "cuda")
        _, caches = lm16.prefill(params, {"tokens": prompts}, caches,
                                 donate=True)
        step = _step_stats(_device_kernels(lambda: lm16.decode_step(
            params, fed[0], caches, SERVE_PROMPT, donate=True)))
        bound_ms = (_step_bytes(lm16, params, caches, SERVE_BATCH)
                    / PEAK_BYTES * 1e3)
        long = _decode_long(lm16, params, prompts, card)
    row = dict(weights_gb=weight_bytes / 1e9, prefill_ms=res["prefill_ms"],
               decode_ms_per_step=res["decode_ms_per_step"],
               tok_per_s=SERVE_BATCH * 1e3 / res["decode_ms_per_step"],
               bound_ms=bound_ms, cache_gb=_tree_bytes(caches) / 1e9,
               bound_all_weights_ms=weight_bytes / PEAK_BYTES * 1e3,
               bound_share=bound_ms / res["decode_ms_per_step"],
               step_kernels=step["kernels"], step_copies=step["copies"],
               step_busy_ms=step["busy_ms"],
               kernels_per_layer=step["kernels"] / cfg.num_layers,
               step_top=step["top"],
               peak_gb=peak / 1e9, allocated_before_gb=base / 1e9,
               decode_errs=errs, long_cache=long,
               tokens=tokens[0].tolist())
    log(f"serve bf16 [{card}]: {SERVE_ARCH} batch {SERVE_BATCH} prompt "
        f"{SERVE_PROMPT} gen {SERVE_GEN} through serve_with (caches "
        f"donated): prefill {row['prefill_ms']:.3f} ms, decode "
        f"{row['decode_ms_per_step']:.3f} ms/step ({row['tok_per_s']:.1f} "
        f"tok/s), bound {bound_ms:.3f} ms (bytes: weights but the embedding "
        f"table, its {SERVE_BATCH} rows, the caches once "
        f"({row['cache_gb']:.4f} GB), the logits; all weights "
        f"{row['bound_all_weights_ms']:.3f} ms) = {row['bound_share']:.1%} "
        f"of the step; one profiled step {step['kernels']} kernels + "
        f"{step['copies']} copies ({row['kernels_per_layer']:.1f} kernels "
        f"per layer), device busy {step['busy_ms']:.3f} ms; peak memory "
        f"{row['peak_gb']:.2f} GB ({row['allocated_before_gb']:.2f} GB "
        f"allocated before); greedy tokens[0] {row['tokens']}")
    log(f"serve bf16 [{card}]: the profiled step's most launched device "
        f"ops: {step['top']}")
    del params, caches, out
    return row


def _serve_mixers(card):
    """The other mixers at their published widths in f32 (SERVE_MIXERS),
    each drawn on the card, checked as qwen3-8b is and freed; an MoE arch
    serves twice and must repeat its logits bit for bit."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from torch.utils._pytree import tree_leaves
    from repro_torch.models.model import LM
    rows = {}
    for arch, layers, b, prompt, gen in SERVE_MIXERS:
        t0 = time.perf_counter()
        full = get_arch(arch)
        cfg = dataclasses.replace(full, dtype="float32",
                                  num_layers=layers or full.num_layers)
        lm = LM(cfg)
        params = lm.init_params(torch.Generator("cuda").manual_seed(0))
        gated = 0
        for gp, (spec, _) in zip(params["layers"], lm.groups):
            if spec.mixer == "xattn":     # a zero gate hides the layer
                gp["mixer"]["gate"].fill_(0.5)
                gated += 1
        n_params = sum(x.numel() for x in tree_leaves(params))
        depth = (f"{layers} of its {full.num_layers} layers (depth cut "
                 f"only)" if layers else f"all {cfg.num_layers} layers")
        gates = f", {gated} cross-attention gates set to 0.5" if gated else ""
        log(f"serve f32 [{card}]: {arch} at its published widths, {depth}"
            f"{gates}, {n_params:,} parameters "
            f"({_tree_bytes(params) / 1e9:.2f} GB f32), batch {b}, prompt "
            f"{prompt}, {gen} decode steps")
        tokens = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                                   (b, prompt))
        batch = {"tokens": torch.from_numpy(tokens).cuda(),
                 **_memory_inputs(cfg, b, 1)}
        with torch.inference_mode():
            last, out, fed, secs, row = _f32_checks(lm, params, batch, gen,
                                                    f"f32 {arch}", card)
            if cfg.num_experts:
                again, out2, _ = _greedy_run(lm, params, batch, gen)
                assert torch.equal(again, last) and all(
                    torch.equal(a, o) for a, o in zip(out2, out)), arch
                log(f"serve f32 {arch} [{card}]: a second greedy run "
                    f"repeats every logit bit for bit OK")
        rows[arch] = dict(row, layers=cfg.num_layers, params=n_params,
                          greedy_s=secs, tokens=torch.cat(fed, 1)[0].tolist())
        del params, last, out, fed
        torch.cuda.empty_cache()
        log(f"serve f32 {arch} [{card}]: greedy prefill + {gen} steps "
            f"{secs:.3f} s; freed, {time.perf_counter() - t0:.1f} s in all")
    return rows


def _reduced_run(lm, params, batch, steps, dev):
    """Prefill `batch` and decode the given tokens (numpy) on `dev`,
    recording every MoE routing: the logits of prefill and of every step,
    the caches after prefill and after the last step, and the routes."""
    import torch
    from torch.utils._pytree import tree_leaves
    from repro_torch.models import moe
    route, routes = moe.route, []

    def recording(*a, **k):
        out = route(*a, **k)
        routes.append(out[2].cpu())
        return out
    moe.route = recording
    try:
        b = {k: (torch.from_numpy(x).to(dev) if k == "tokens" else
                 torch.from_numpy(x).float().to(dev))
             for k, x in batch.items()}
        with torch.inference_mode():
            caches = lm.init_caches(SERVE_BATCH, SERVE_PROMPT
                                    + SERVE_REDUCED_STEPS, dev)
            last, caches = lm.prefill(params, b, caches)
            logits = [last]
            prefill_caches = tree_leaves(caches)
            for i in range(SERVE_REDUCED_STEPS):
                out, caches = lm.decode_step(
                    params, torch.from_numpy(steps[:, i:i + 1]).to(dev),
                    caches, SERVE_PROMPT + i)
                logits.append(out)
    finally:
        moe.route = route
    v = lm.cfg.vocab_size
    return dict(logits=[x[..., :v] for x in logits],
                caches=prefill_caches + tree_leaves(caches), routes=routes)


def _serve_reduced(card):
    """The ten archs, reduced, through serve on the card; then the same
    parameters (drawn on the card as serve draws them) on the card and the
    CPU: prefill logits, every cache leaf, and SERVE_REDUCED_STEPS decode
    steps' logits within SERVE_CARD_CPU_REL; MoE routing indices equal,
    and an MoE arch's card run repeated bit for bit."""
    import numpy as np
    import torch
    from repro_torch.configs import ARCH_IDS, get_arch
    from repro_torch.launch.serve import serve
    from torch.utils._pytree import tree_map
    from repro_torch.models.model import LM
    rows = {}
    for arch in ARCH_IDS:
        res = serve(arch, True, SERVE_BATCH, SERVE_PROMPT, SERVE_GEN,
                    device="cuda")
        lm = LM(get_arch(arch).reduced())
        cfg, v = lm.cfg, lm.cfg.vocab_size
        card_params = lm.init_params(torch.Generator("cuda").manual_seed(0))
        host_params = tree_map(lambda x: x.cpu(), card_params)
        rng = np.random.default_rng(1)
        batch = {"tokens": rng.integers(0, v, (SERVE_BATCH, SERVE_PROMPT))}
        if cfg.is_encdec:
            batch["audio_embed"] = rng.standard_normal(
                (SERVE_BATCH, cfg.num_audio_frames, cfg.d_model))
        if cfg.num_image_tokens:
            batch["image_embed"] = rng.standard_normal(
                (SERVE_BATCH, cfg.num_image_tokens, cfg.d_model))
        steps = rng.integers(0, v, (SERVE_BATCH, SERVE_REDUCED_STEPS))
        seen = {dev: _reduced_run(lm, params, batch, steps, dev)
                for dev, params in (("cuda", card_params),
                                    ("cpu", host_params))}
        errs = {}
        for what in ("logits", "caches"):
            pairs = list(zip(seen["cuda"][what], seen["cpu"][what]))
            assert len(pairs) == len(seen["cpu"][what])
            errs[what] = max(_rel_close(a.cpu(), b, f"serve {arch} {what}",
                                        SERVE_CARD_CPU_REL) for a, b in pairs)
        routes = seen["cuda"]["routes"]
        assert len(routes) == len(seen["cpu"]["routes"])
        assert all(torch.equal(a, b) for a, b in zip(routes,
                                                     seen["cpu"]["routes"]))
        assert (len(routes) > 0) == bool(cfg.num_experts), (arch, len(routes))
        repeat = ""
        if cfg.num_experts:
            again = _reduced_run(lm, card_params, batch, steps, "cuda")
            for what in ("logits", "caches", "routes"):
                assert all(torch.equal(a, b) for a, b in zip(
                    again[what], seen["cuda"][what])), (arch, what)
            repeat = ", a second card run repeats it bit for bit"
        rows[arch] = dict(prefill_ms=res["prefill_ms"],
                          decode_ms_per_step=res["decode_ms_per_step"],
                          sample_output=res["sample_output"],
                          routing_calls=len(routes), **errs)
        log(f"serve reduced [{card}]: {arch} serve prefill "
            f"{res['prefill_ms']:.3f} ms, decode "
            f"{res['decode_ms_per_step']:.3f} ms/step, tokens "
            f"{res['sample_output']}; card vs CPU: logits {errs['logits']:.2e}"
            f", caches {errs['caches']:.2e} (bar {SERVE_CARD_CPU_REL}), "
            f"routing {len(routes)} calls equal{repeat} OK")
    return rows


def phase_serve():
    """The LM serve path on the card (see the module docstring, 7e)."""
    import torch
    t0 = time.perf_counter()
    card = nvidia_smi_line()
    torch.cuda.empty_cache()
    full = _serve_full(card)
    torch.cuda.empty_cache()
    log(f"serve: {SERVE_ARCH} freed, {torch.cuda.memory_allocated() / 1e9:.2f}"
        f" GB still allocated; full-width part {time.perf_counter() - t0:.1f}"
        f" s")
    mixers = _serve_mixers(card)
    reduced = _serve_reduced(card)
    log(f"serve [{card}]: " + json.dumps(dict(full=full, mixers=mixers,
                                              reduced=reduced)))
    log(f"serve: phase took {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------
# The LM zoo's training path: qwen3-8b at its published widths cut to 4
# layers, the other mixers, and the ten reduced archs card against CPU
# ---------------------------------------------------------------------

TRAIN_ARCH, TRAIN_LAYERS = "qwen3-8b", 4
TRAIN_BATCH, TRAIN_SEQ = 8, 128          # the JAX launcher's defaults
TRAIN_STEPS, TRAIN_TIMED = 20, 8
TRAIN_LOSS_REL = 1e-6                    # f32 vs f64 loss, relative
TRAIN_GRAD_REL = 1e-4                    # f32 vs f64, per gradient leaf
TRAIN_CARD_CPU_REL = 1e-5                # reduced archs: card vs CPU losses
TRAIN_REDUCED_STEPS = 3
PEAK_BF16_FLOPS = 989e12   # H100 SXM bf16 tensor cores, dense (data sheet)
# the other mixers at their published widths in bf16, 5 steps each: (arch,
# decoder layers kept or None for all); then the f32-vs-f64 gradient check
# at a cut depth: (decoder layers, encoder layers or None)
TRAIN_MIXERS = (
    ("mamba2-780m", None, (2, None)),            # SSD, chunk 256
    ("granite-moe-1b-a400m", None, (2, None)),   # MoE: 32 experts, top-8
    ("whisper-large-v3", None, (2, 2)),          # enc-dec, 1500 frames
    ("recurrentgemma-2b", 12, (3, None)),        # RG-LRU: one r-r-a unit
)
TRAIN_MIXER_STEPS = 5


def _train_opt(steps: int):
    """The JAX launcher's optimizer for an LM run of `steps` steps."""
    from repro_torch.optim import adamw, linear_warmup_cosine
    return adamw(linear_warmup_cosine(3e-4, 10, steps), max_grad_norm=1.0)


def _train_stream(cfg, seed: int = 0):
    from repro_torch.data import TokenStream
    return iter(TokenStream(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH,
                            seed=seed))


def _train_split_steps(lm, params, n: int):
    """`n` more steps from `params`, each as train_lm runs it (batch,
    loss_and_grads, opt.apply) with a device sync after the forward +
    backward and after opt.apply: (forward + backward ms, opt.apply ms,
    the last step's parameters), and one profiled step's device ops."""
    import torch
    from repro_torch.launch.train import lm_batch, loss_and_grads
    opt = _train_opt(TRAIN_STEPS)
    state = opt.init(params)
    stream = _train_stream(lm.cfg, 1)
    fb, upd = [], []

    def step(params, state):
        batch = lm_batch(next(stream), lm, "cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, grads = loss_and_grads(lm, params, batch)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        with torch.no_grad():
            params, state = opt.apply(params, grads, state)
        torch.cuda.synchronize()
        fb.append((t1 - t0) * 1e3)
        upd.append((time.perf_counter() - t1) * 1e3)
        assert bool(torch.isfinite(loss)), loss
        return params, state
    for _ in range(n):
        params, state = step(params, state)
    prof = _step_stats(_device_kernels(lambda: step(params, state)))
    return fb[:n], upd[:n], prof


def _median(xs):
    q = sorted(xs)
    return (q[(len(q) - 1) // 2] + q[len(q) // 2]) / 2


def _train_full(card):
    """qwen3-8b at its published widths cut to TRAIN_LAYERS layers, bf16
    with remat as its config has them: TRAIN_STEPS steps of train_lm, then
    TRAIN_TIMED steps timed with forward + backward and opt.apply apart
    and one profiled step."""
    import dataclasses
    import torch
    from torch.utils._pytree import tree_leaves
    from repro_torch.analysis import analytic_cost
    from repro_torch.configs import get_arch
    from repro_torch.launch.train import train_lm
    from repro_torch.models.config import InputShape
    from repro_torch.models.model import LM
    full = get_arch(TRAIN_ARCH)
    cfg = dataclasses.replace(full, num_layers=TRAIN_LAYERS)
    assert cfg.dtype == "bfloat16" and cfg.remat
    lm = LM(cfg)
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    params = lm.init_params(torch.Generator("cuda").manual_seed(0))
    n_params = sum(x.numel() for x in tree_leaves(params))
    reckoned_gb = 24 * n_params / 1e9        # bf16 p, g; f32 mu, nu; twice
    log(f"lm_train [{card}]: {TRAIN_ARCH} at its published widths, "
        f"{TRAIN_LAYERS} of its {full.num_layers} layers, {n_params:,} "
        f"parameters, bf16, remat on; batch {TRAIN_BATCH} x seq "
        f"{TRAIN_SEQ}, {TRAIN_STEPS} steps of train_lm")
    losses, params, secs = train_lm(lm, params, _train_opt(TRAIN_STEPS),
                                    _train_stream(cfg), TRAIN_STEPS,
                                    log=None)
    peak = torch.cuda.max_memory_allocated() - base
    assert all(math.isfinite(v) for v in losses), losses
    assert losses[-1] < losses[0], (losses[0], losses[-1])
    fb, upd, prof = _train_split_steps(lm, params, TRAIN_TIMED)
    steps = [a + b for a, b in zip(fb, upd)]
    step_ms = _median(steps)
    shape = InputShape("lm_train", TRAIN_SEQ, TRAIN_BATCH, "train")
    train_flops = analytic_cost(cfg, shape)["flops_global"]
    model_flops = 3 * train_flops / 4      # the count includes remat's
    row = dict(params=n_params, first_loss=losses[0], last_loss=losses[-1],
               losses=losses, loop_s=secs, step_ms=step_ms,
               step_ms_all=steps, fwd_bwd_ms=_median(fb),
               opt_apply_ms=_median(upd),
               opt_share=_median(upd) / step_ms,
               tokens_per_s=TRAIN_BATCH * TRAIN_SEQ / step_ms * 1e3,
               model_flops=model_flops,
               model_flops_share=model_flops / (step_ms / 1e3)
               / PEAK_BF16_FLOPS,
               peak_gb=peak / 1e9, reckoned_peak_gb=reckoned_gb,
               step_ops=prof["kernels"], step_copies=prof["copies"],
               step_busy_ms=prof["busy_ms"],
               step_idle_share=1 - prof["busy_ms"] / step_ms,
               step_top=prof["top"])
    log(f"lm_train [{card}]: {TRAIN_ARCH} x{TRAIN_LAYERS} bf16 loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f} over {TRAIN_STEPS} steps "
        f"({secs:.2f} s, finite, falling) OK; median step of "
        f"{TRAIN_TIMED} {step_ms:.3f} ms = forward + backward "
        f"{row['fwd_bwd_ms']:.3f} + opt.apply {row['opt_apply_ms']:.3f} "
        f"ms ({row['opt_share']:.1%} in the optimizer); "
        f"{row['tokens_per_s']:.1f} tokens/s; model-FLOPs share "
        f"{row['model_flops_share']:.2%} (3 x forward FLOPs of "
        f"analytic_cost, {model_flops / 1e12:.2f} TFLOP, / step time / "
        f"989 TFLOP/s bf16 dense peak); peak memory {row['peak_gb']:.2f} "
        f"GB (reckoned ~{reckoned_gb:.1f} GB: 24 bytes per parameter); one "
        f"profiled step {prof['kernels']} device ops + {prof['copies']} "
        f"copies, device busy {prof['busy_ms']:.3f} ms (idle share "
        f"{row['step_idle_share']:.1%})")
    log(f"lm_train [{card}]: the profiled step's most launched device ops: "
        f"{prof['top']}")
    del params
    torch.cuda.empty_cache()
    return row


def _zero_grad_by_structure(cfg, path: str) -> bool:
    """A key bias without RoPE or qk-norm adds q·bk to all of a query's
    scores, which the softmax cancels: its exact gradient is 0."""
    return path.endswith("['bk']") and not (cfg.use_rope or cfg.qk_norm)


def _grads_against(cfg, run, ref, what, card):
    """A run's (loss, grads) against a reference's: the loss within
    TRAIN_LOSS_REL, each gradient leaf within TRAIN_GRAD_REL in relative
    norm (a leaf zero by structure against its layer's wk gradient); the
    worst leaf and whether everything is bit-equal."""
    import torch
    from torch.utils._pytree import keystr, tree_flatten_with_path
    (loss, grads), (rloss, rgrads) = run, ref
    loss_rel = abs(float(loss) - float(rloss)) / abs(float(rloss))
    assert loss_rel <= TRAIN_LOSS_REL, (what, float(loss), float(rloss))
    got, want = ({keystr(k): v for k, v in tree_flatten_with_path(t)[0]}
                 for t in (grads, rgrads))
    assert list(got) == list(want)
    worst, equal = (0.0, ""), bool(torch.equal(loss, rloss))
    for path, w in want.items():
        g = got[path]
        assert bool(torch.isfinite(g).all()), (what, path)
        diff = float(torch.linalg.vector_norm((g.double() - w.double())))
        scale = float(torch.linalg.vector_norm(w.double()))
        if _zero_grad_by_structure(cfg, path):
            scale = float(torch.linalg.vector_norm(
                want[path[:-len("['bk']")] + "['wk']"].double()))
        rel = diff / scale if scale else diff
        assert rel <= TRAIN_GRAD_REL, (what, path, rel)
        worst = max(worst, (rel, path))
        equal = equal and g.dtype == w.dtype and bool(torch.equal(g, w))
    log(f"lm_train {what} [{card}]: loss rel {loss_rel:.3e} (bar "
        f"{TRAIN_LOSS_REL}), {len(want)} gradient leaves, worst "
        f"{worst[0]:.3e} at {worst[1]} (bar {TRAIN_GRAD_REL}); bit-equal: "
        f"{equal} OK")
    return dict(loss_rel=loss_rel, worst_leaf_rel=worst[0],
                worst_leaf=worst[1], bit_equal=equal)


def _f64_check(cfg, card, remat_too=False):
    """cfg's model in f32 on the card (dense products in full f32) against
    the same parameters in f64 on the card, on one TokenStream batch with
    numpy-seeded memory where the arch reads it: loss and every gradient
    leaf; with `remat_too`, f32 with remat on against off."""
    import dataclasses
    import torch
    from torch.utils._pytree import tree_map
    from repro_torch.launch.train import lm_batch, loss_and_grads
    from repro_torch.models.model import LM
    f64 = torch.float64
    lm32 = LM(dataclasses.replace(cfg, dtype="float32", remat=True))
    lm64 = LM(dataclasses.replace(cfg, dtype="float64", remat=True))
    params = lm32.init_params(torch.Generator("cuda").manual_seed(0))
    batch = lm_batch(next(_train_stream(cfg)), lm32, "cuda")
    batch.update(_memory_inputs(cfg, TRAIN_BATCH, 1))
    ref = loss_and_grads(lm64, tree_map(lambda x: x.to(f64), params),
                         {k: v.to(f64) if v.is_floating_point() else v
                          for k, v in batch.items()})
    run = loss_and_grads(lm32, params, batch)
    out = {"f32_vs_f64": _grads_against(cfg, run, ref, f"{cfg.arch_id} "
                                        "f32 vs f64", card)}
    del ref
    if remat_too:
        off = LM(dataclasses.replace(lm32.cfg, remat=False))
        out["remat_on_vs_off"] = _grads_against(
            cfg, run, loss_and_grads(off, params, batch),
            f"{cfg.arch_id} f32 remat on vs off", card)
    del params, run
    torch.cuda.empty_cache()
    return out


def _train_mixers(card):
    """The other mixers at their published widths in bf16 (TRAIN_MIXERS),
    TRAIN_MIXER_STEPS steps each: loss, ms per step, peak memory; then the
    f32-vs-f64 gradient check at a cut depth; each model freed."""
    import dataclasses
    import torch
    from torch.utils._pytree import tree_leaves
    from repro_torch.configs import get_arch
    from repro_torch.launch.train import train_lm
    from repro_torch.models.model import LM
    rows = {}
    for arch, layers, (cut, enc_cut) in TRAIN_MIXERS:
        full = get_arch(arch)
        cfg = dataclasses.replace(full, num_layers=layers or full.num_layers)
        lm = LM(cfg)
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        params = lm.init_params(torch.Generator("cuda").manual_seed(0))
        n_params = sum(x.numel() for x in tree_leaves(params))
        losses, params, secs = train_lm(
            lm, params, _train_opt(TRAIN_MIXER_STEPS), _train_stream(cfg),
            TRAIN_MIXER_STEPS, log=None)
        peak = torch.cuda.max_memory_allocated() - base
        assert all(math.isfinite(v) for v in losses), (arch, losses)
        del params
        torch.cuda.empty_cache()
        depth = (f"{layers} of its {full.num_layers} layers" if layers
                 else f"all {cfg.num_layers} layers")
        log(f"lm_train [{card}]: {arch} at its published widths, {depth}, "
            f"{n_params:,} parameters, {cfg.dtype}, remat {cfg.remat}: "
            f"loss {losses[0]:.4f} -> {losses[-1]:.4f} over "
            f"{TRAIN_MIXER_STEPS} steps, {secs / TRAIN_MIXER_STEPS * 1e3:.1f}"
            f" ms per step (the first included), peak memory "
            f"{peak / 1e9:.2f} GB (reckoned ~{24 * n_params / 1e9:.1f} GB)")
        small = dataclasses.replace(
            full, num_layers=cut,
            encoder_layers=enc_cut if enc_cut else full.encoder_layers)
        rows[arch] = dict(params=n_params, losses=losses,
                          ms_per_step=secs / TRAIN_MIXER_STEPS * 1e3,
                          peak_gb=peak / 1e9,
                          check_layers=(cut, enc_cut),
                          **_f64_check(small, card))
    return rows


def _backward_index_ops(lm, params, batch) -> list:
    """The device kernels of one backward whose names point at indexed
    accumulation (the ops that may add in no fixed order)."""
    from repro_torch.launch.train import loss_and_grads
    names = _device_kernels(lambda: loss_and_grads(lm, params, batch))
    keys = ("atomic", "index", "scatter", "put", "embedding")
    return sorted(k[:80] for k in names if any(s in k.lower() for s in keys))


def _train_reduced(card):
    """The ten archs, reduced, through the CLI on the card (--workload lm
    --reduced --steps TRAIN_REDUCED_STEPS); then the same parameters drawn
    on the card as run_lm draws them through train_lm on the card (does it
    repeat the CLI bit for bit?) and, carried over, on the CPU: every loss
    within TRAIN_CARD_CPU_REL."""
    import contextlib
    import io
    import torch
    from torch.utils._pytree import tree_map
    from repro_torch.configs import ARCH_IDS, get_arch
    from repro_torch.launch.train import lm_batch, main, train_lm
    from repro_torch.models.model import LM
    rows = {}
    for arch in ARCH_IDS:
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            res = main(["--workload", "lm", "--arch", arch, "--reduced",
                        "--steps", str(TRAIN_REDUCED_STEPS)])
        assert res["device"] == "cuda", res
        lm = LM(get_arch(arch).reduced())
        card_params = lm.init_params(torch.Generator("cuda").manual_seed(0))
        host_params = tree_map(lambda x: x.cpu(), card_params)
        seen = {}
        for dev, params in (("cuda", card_params), ("cpu", host_params)):
            seen[dev] = train_lm(lm, params, _train_opt(TRAIN_REDUCED_STEPS),
                                 _train_stream(lm.cfg), TRAIN_REDUCED_STEPS,
                                 log=None)[0]
        card_losses, host_losses = seen["cuda"], seen["cpu"]
        repeats = (card_losses[0] == res["first_loss"]
                   and card_losses[-1] == res["last_loss"])
        assert abs(card_losses[0] - res["first_loss"]) <= \
            TRAIN_CARD_CPU_REL * abs(res["first_loss"])
        assert abs(card_losses[-1] - res["last_loss"]) <= \
            TRAIN_CARD_CPU_REL * abs(res["last_loss"])
        errs = [abs(a - b) / abs(b) for a, b in zip(card_losses, host_losses)]
        assert max(errs) <= TRAIN_CARD_CPU_REL, (arch, errs)
        ops = [] if repeats else _backward_index_ops(
            lm, card_params, lm_batch(next(_train_stream(lm.cfg)), lm,
                                      "cuda"))
        rows[arch] = dict(first_loss=res["first_loss"],
                          last_loss=res["last_loss"],
                          steps_per_sec=res["steps_per_sec"],
                          card_losses=card_losses, cpu_losses=host_losses,
                          card_vs_cpu=max(errs), repeats_bitwise=repeats,
                          index_ops=ops)
        log(f"lm_train reduced [{card}]: {arch} through the CLI loss "
            f"{res['first_loss']:.6f} -> {res['last_loss']:.6f} "
            f"({res['steps_per_sec']:.2f} steps/s); train_lm on the card "
            f"repeats it bit for bit: {repeats}"
            + (f" (backward index ops {ops})" if ops else "")
            + f"; card vs CPU losses within {max(errs):.2e} (bar "
            f"{TRAIN_CARD_CPU_REL}) OK")
        del card_params, host_params
    return rows


def phase_lm_train():
    """The LM training path on the card (see the module docstring, 7f)."""
    import dataclasses
    import torch
    from repro_torch.configs import get_arch
    t0 = time.perf_counter()
    card = nvidia_smi_line()
    reset_launches()
    full = _train_full(card)
    checks = _f64_check(dataclasses.replace(get_arch(TRAIN_ARCH),
                                            num_layers=2), card,
                        remat_too=True)
    mixers = _train_mixers(card)
    reduced = _train_reduced(card)
    launches = read_launches()
    assert not any(launches.values()), launches
    log(f"lm_train [{card}]: no port kernel launched in the phase "
        f"({launches}) OK")
    log(f"lm_train [{card}]: " + json.dumps(dict(
        full=full, full_width_2_layers=checks, mixers=mixers,
        reduced=reduced)))
    torch.cuda.empty_cache()
    log(f"lm_train: phase took {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------
# The production dry-run: rank 0 of the 16×16 and 2×16×16 meshes on a fake
# process group (every collective a no-op), PipeGCN and the LM zoo
# ---------------------------------------------------------------------

# (multi_pod, variant, fuse_exchange, overlap) of the PipeGCN runs: PROD
# (papers100M-scale rank 0) on 16×16, SMALL (Reddit-scale) on 2×16×16
DRYRUN_GCN = (
    (False, "pipegcn", True, "auto"),
    (False, "pipegcn", False, "auto"),
    (False, "vanilla", True, "auto"),
    (False, "pipegcn", True, "split-phase"),
    (True, "pipegcn", True, "auto"),
)
DRYRUN_LM_ARCH = "qwen3-8b"
DRYRUN_MOE_ARCH = "granite-moe-1b-a400m"
DRYRUN_STEPS = 2                   # timed card steps per LM shape
DRYRUN_GCN_STEPS = 3
DRYRUN_CARD_SHARE = 0.75           # meta bytes per device / card memory
DRYRUN_MUST_RUN = ("train_4k", "decode_32k")
DRYRUN_ROUTED_CARD = ("granite-moe-1b-a400m", "mamba2-780m")  # train_4k
DRYRUN_BYTES_TOL = 0.15            # meta bytes per device vs card peak
DRYRUN_MESHES = {"16x16": 256, "2x16x16": 512}     # mesh: chips


def _jax_rows():
    """JAX's dry-run rows as data, with the checks that hold the port's rows
    to them (tests/_dryrun_jax_rows.py)."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import _dryrun_jax_rows
    return _dryrun_jax_rows


def _dryrun_gcn(card):
    from repro_torch.core.trace_utils import expected_boundary_collectives
    from repro_torch.launch.dryrun_pipegcn import dryrun_pipegcn
    rows = []
    for mp, variant, fuse, overlap in DRYRUN_GCN:
        r = dryrun_pipegcn(mp, variant, fuse=fuse, overlap=overlap,
                           device="cuda", steps=DRYRUN_GCN_STEPS)
        sz = r["sizes"]
        fused = fuse and variant != "vanilla"
        want = expected_boundary_collectives(sz["num_layers"], fused)
        assert want == (2 if fused else 2 * sz["num_layers"] - 1)
        assert r["boundary_collectives_per_step"] == want, r
        assert r["boundary_collectives_expected"] == want, r
        assert r["collective_counts_per_device"]["all-to-all"] == want, r
        dims = [sz["feat_dim"]] + [sz["hidden"]] * (sz["num_layers"] - 1)
        wire = r["chips"] * sz["slot"] * (sum(dims) + sum(dims[1:])) * 4
        assert r["boundary_wire_bytes"] == r["recorded_wire_bytes"] == wire
        assert r["peak_bytes"] >= r["argument_size_in_bytes"] > 0, r
        assert math.isfinite(r["step_ms"]) and r["step_ms"] > 0, r
        if overlap == "split-phase":
            assert "scatter-add" in r["overlap_events"], r
        tag = (f"{'SMALL 2x16x16' if mp else 'PROD 16x16'} {variant} "
               f"{'fused' if fuse else 'per-layer'} {overlap}")
        log(f"dryrun [{card}]: pipegcn {tag}: step {r['step_ms']:.3f} ms "
            f"(of {DRYRUN_GCN_STEPS}: {r['step_ms_all']}), peak "
            f"{r['peak_bytes']} B beside {r['argument_size_in_bytes']} B of "
            f"arguments; boundary collectives {want} (expected {want}) OK; "
            f"wire {wire} B == JAX's formula OK; collectives "
            f"{r['collective_counts_per_device']}")
        rows.append({k: r[k] for k in (
            "arch", "multi_pod", "fuse_exchange", "overlap", "chips",
            "step_ms", "step_ms_all", "peak_bytes", "argument_size_in_bytes",
            "boundary_collectives_per_step", "boundary_wire_bytes",
            "collective_counts_per_device", "collective_bytes_per_device",
            "t_compute", "t_memory", "t_collective", "bottleneck")})
    return rows


def _dryrun_bytes(card, tag, meta, r):
    """Log and hold the abstract run's bytes per device (arguments + the
    peak of the step's own storages, `StepMemory`) against the card's
    allocator peak of the same combo."""
    ratio = meta["bytes_per_device"] / r["peak_bytes"]
    log(f"dryrun [{card}]: {tag}: meta bytes per device "
        f"{meta['bytes_per_device']} B (arguments "
        f"{meta['argument_size_in_bytes']}, temporaries "
        f"{meta['temp_size_in_bytes']}) beside the card's peak "
        f"{r['peak_bytes']} B: {ratio:.4f}")
    assert abs(ratio - 1) <= DRYRUN_BYTES_TOL, (tag, ratio)
    return ratio


def _dryrun_lm(card):
    import torch
    from repro_torch.launch.dryrun import dryrun_one
    from repro_torch.models.config import INPUT_SHAPES
    total = torch.cuda.get_device_properties(0).total_memory
    rows = {}
    for name in INPUT_SHAPES:
        meta = dryrun_one(DRYRUN_LM_ARCH, name, device="meta")
        fits = meta["bytes_per_device"] <= DRYRUN_CARD_SHARE * total
        assert fits or name not in DRYRUN_MUST_RUN, (name, meta)
        row = {"meta": meta, "card_bytes": total}
        log(f"dryrun [{card}]: {DRYRUN_LM_ARCH} {name} 16x16 abstract: "
            f"arguments {meta['argument_size_in_bytes']} B, bytes per device "
            f"{meta['bytes_per_device']} of {total} ("
            f"{'runs' if fits else 'skipped'} on the card); collectives "
            f"{meta['collective_counts_per_device']}, "
            f"{meta['collective_total_bytes']} B; bottleneck "
            f"{meta['bottleneck']}")
        if fits:
            r = dryrun_one(DRYRUN_LM_ARCH, name, device="cuda",
                           steps=DRYRUN_STEPS)
            assert (r["argument_size_in_bytes"]
                    == meta["argument_size_in_bytes"]), (r, meta)
            assert r["peak_bytes"] >= r["argument_size_in_bytes"], r
            assert math.isfinite(r["step_ms"]) and r["step_ms"] > 0, r
            # the card's step issues the collectives the abstract run
            # counted, each of the same size
            for key in ("collective_counts_per_device",
                        "collective_bytes_per_device"):
                assert r[key] == meta[key], (key, r[key], meta[key])
            assert r["collective_counts_per_device"]["all-gather"] > 0, r
            row["card"] = r
            row["meta_over_peak"] = _dryrun_bytes(
                card, f"{DRYRUN_LM_ARCH} {name} 16x16", meta, r)
            log(f"dryrun [{card}]: {DRYRUN_LM_ARCH} {name} 16x16 card: step "
                f"{r['step_ms']:.1f} ms (of {DRYRUN_STEPS}: "
                f"{[round(t, 1) for t in r['step_ms_all']]}), peak "
                f"{r['peak_bytes']} B beside {r['argument_size_in_bytes']} B "
                f"of arguments (== abstract OK); collectives (== abstract "
                f"OK) "
                f"{r['collective_counts_per_device']}, "
                f"{r['collective_total_bytes']} B")
        rows[name] = row
    log(f"dryrun [{card}]: collective table, {DRYRUN_LM_ARCH} 16x16, per "
        f"device (count / bytes):")
    from repro_torch.core.trace_utils import COLLECTIVE_OPS
    log("  shape        mode " + "".join(f"{k:>26}" for k in COLLECTIVE_OPS))
    for name, row in rows.items():
        for mode in ("meta", "card"):
            m = row.get(mode)
            if m is None:
                continue
            log(f"  {name:<12} {mode:<5}" + "".join(
                f"{m['collective_counts_per_device'][k]:>8} / "
                f"{m['collective_bytes_per_device'][k]:<15}"
                for k in COLLECTIVE_OPS))
    moe = dryrun_one(DRYRUN_MOE_ARCH, "train_4k", device="meta",
                     opt_sharding=True)
    assert sum(moe["collective_counts_per_device"].values()) > 0, moe
    log(f"dryrun [{card}]: {DRYRUN_MOE_ARCH} train_4k 16x16 --opt-sharding "
        f"abstract: arguments {moe['argument_size_in_bytes']} B, bytes per "
        f"device {moe['bytes_per_device']}, collectives "
        f"{moe['collective_counts_per_device']}, "
        f"{moe['collective_total_bytes']} B; bottleneck {moe['bottleneck']}")
    assert all(name in rows and "card" in rows[name]
               for name in DRYRUN_MUST_RUN)
    return rows, moe


def _dryrun_sweeps(out_dir):
    """The dry-run's CLI, ``--all --shape S --device meta``, one process per
    mesh and shape, started side by side: {(mesh, shape): (process, its
    rows' file)}."""
    from repro_torch.models.config import INPUT_SHAPES
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(ROOT, "src"), os.environ.get("PYTHONPATH", "")]))
    procs = {}
    for mesh in DRYRUN_MESHES:
        for shape in INPUT_SHAPES:
            out = os.path.join(out_dir, f"dryrun_{mesh}_{shape}.json")
            with open(out + ".log", "w") as logf:
                procs[mesh, shape] = (subprocess.Popen(
                    [sys.executable, "-m", "repro_torch.launch.dryrun",
                     "--all", "--shape", shape, "--device", "meta", "--out",
                     out] + (["--multi-pod"] if mesh == "2x16x16" else []),
                    stdout=logf, stderr=subprocess.STDOUT, env=env), out)
    return procs


def _dryrun_sweep_rows(card, procs, gcn):
    """The sweeps' rows of each mesh, with the PipeGCN rows `gcn` of that
    mesh, held to JAX's artifact gates (`check_rows`: 40 of 40 LM rows,
    none with an error) and to JAX's rows (`check_against_jax`), the MoE
    rows' collective bytes logged beside JAX's."""
    from repro_torch.launch.dryrun import check_rows
    jax = _jax_rows()
    t0 = time.perf_counter()
    rows = {mesh: [] for mesh in DRYRUN_MESHES}
    for (mesh, shape), (proc, out) in procs.items():
        proc.wait(timeout=900)
        with open(out + ".log") as f:
            assert proc.returncode == 0, (mesh, shape, f.read()[-3000:])
        with open(out) as f:
            rows[mesh] += json.load(f)
    secs = time.perf_counter() - t0
    for mesh, got in rows.items():
        chips = DRYRUN_MESHES[mesh]
        pipegcn = [r for r in gcn if r["chips"] == chips]
        assert pipegcn, mesh
        check_rows(got + pipegcn, chips)
        versus = jax.check_against_jax(got, mesh)
        log(f"dryrun [{card}]: --all --device meta {mesh}: {len(got)} rows, "
            f"none with an error, JAX's artifact gates OK (with "
            f"{len(pipegcn)} PipeGCN rows), JAX's rows OK, "
            f"{sum(r['run_s'] for r in got):.1f} s of steps")
        for r in got:
            key = (r["arch"], r["shape"])
            d, ratio = versus[key]
            f5 = key + (mesh,) in jax.F5
            moe = jax.moe_output_reduction(*key, mesh)[0] > 0
            log(f"  {mesh:<8} {r['arch']:<22} {r['shape']:<12} arguments "
                f"{r['argument_size_in_bytes']:>13} (JAX - port {d}, "
                f"{r['unused_argument_leaves']} unread) bytes/device "
                f"{r['bytes_per_device']:>15} collectives "
                f"{r['collective_total_bytes']:>16} (JAX "
                f"{jax.COLLECTIVE_BYTES[mesh][key]:>16}, {ratio:.3f}x"
                f"{f', F5 bar {jax.FACTOR}x OK' if f5 else ''}"
                f"{'; MoE: all-reduce floor OK' if moe else ''})")
    log(f"dryrun [{card}]: the {len(procs)} sweep processes: {secs:.1f} s "
        f"after the card work")
    return rows


def _dryrun_routed(card):
    """DRYRUN_ROUTED_CARD's train_4k on 16×16 on the card under global
    routing, whose abstract bytes per device must fit DRYRUN_CARD_SHARE of
    the card: its collectives equal to the abstract run's, its meta bytes
    within DRYRUN_BYTES_TOL of the card's peak."""
    import torch
    from repro_torch.launch.dryrun import dryrun_one
    total = torch.cuda.get_device_properties(0).total_memory
    cards = {}
    for arch in DRYRUN_ROUTED_CARD:
        meta = dryrun_one(arch, "train_4k", device="meta")
        assert meta["bytes_per_device"] <= DRYRUN_CARD_SHARE * total, (
            arch, meta["bytes_per_device"], total)
        r = dryrun_one(arch, "train_4k", device="cuda", steps=DRYRUN_STEPS)
        assert r["argument_size_in_bytes"] == meta["argument_size_in_bytes"]
        assert r["peak_bytes"] >= r["argument_size_in_bytes"], r
        assert math.isfinite(r["step_ms"]) and r["step_ms"] > 0, r
        for key in ("collective_counts_per_device",
                    "collective_bytes_per_device"):
            assert r[key] == meta[key], (arch, key, r[key], meta[key])
        tag = f"{arch} train_4k 16x16"
        cards[arch] = {k: r[k] for k in (
            "step_ms", "step_ms_all", "peak_bytes", "argument_size_in_bytes",
            "collective_counts_per_device", "collective_bytes_per_device")}
        cards[arch].update(
            meta_bytes_per_device=meta["bytes_per_device"],
            meta_over_peak=_dryrun_bytes(card, tag, meta, r))
        log(f"dryrun [{card}]: {tag} card (routed forms): "
            f"step {r['step_ms']:.1f} ms (of {DRYRUN_STEPS}: "
            f"{[round(t, 1) for t in r['step_ms_all']]}), peak "
            f"{r['peak_bytes']} B beside {r['argument_size_in_bytes']} B of "
            f"arguments; collectives == abstract OK "
            f"{r['collective_counts_per_device']}, "
            f"{r['collective_total_bytes']} B")
    return cards


def phase_dryrun():
    """The production dry-run on the card (see the module docstring, 7g)."""
    import tempfile

    import torch
    t0 = time.perf_counter()
    card = nvidia_smi_line()
    torch.cuda.empty_cache()
    reset_launches()
    gcn = _dryrun_gcn(card)
    lm, moe = _dryrun_lm(card)
    routed = _dryrun_routed(card)
    launches = read_launches()
    log(f"dryrun: the card work took {time.perf_counter() - t0:.1f} s")
    # the abstract sweeps only now, so no card step above was timed beside
    # them
    with tempfile.TemporaryDirectory() as tmp:
        sweep = _dryrun_sweep_rows(card, _dryrun_sweeps(tmp), gcn)
    assert not any(launches.values()), launches
    log(f"dryrun [{card}]: no port kernel launched in the phase "
        f"({launches}) OK")
    slim = {name: {"meta": {k: row["meta"][k] for k in (
        "argument_size_in_bytes", "bytes_per_device",
        "collective_counts_per_device", "collective_bytes_per_device",
        "flops_per_device", "t_compute", "t_memory", "t_collective",
        "bottleneck")},
        "meta_over_peak": row.get("meta_over_peak"),
        "card": {k: row["card"][k] for k in (
            "step_ms", "step_ms_all", "peak_bytes",
            "collective_counts_per_device", "collective_bytes_per_device")}
        if "card" in row
        else None} for name, row in lm.items()}
    log(f"dryrun [{card}]: " + json.dumps(dict(
        pipegcn=gcn, lm=slim, moe={k: moe[k] for k in (
            "arch", "shape", "opt_sharding", "argument_size_in_bytes",
            "bytes_per_device", "collective_counts_per_device",
            "collective_bytes_per_device", "bottleneck")},
        sweep={mesh: {f"{r['arch']} {r['shape']}": {f: r[f] for f in (
            "argument_size_in_bytes", "unused_argument_leaves",
            "bytes_per_device", "collective_total_bytes",
            "collective_counts_per_device", "collective_bytes_per_device",
            "bottleneck", "run_s")} for r in rows}
            for mesh, rows in sweep.items()},
        routed_card=routed)))
    torch.cuda.empty_cache()
    log(f"dryrun: phase took {time.perf_counter() - t0:.1f} s")


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
    phase_wire(reddit, yelp, split_pipes, runs)
    phase_faults(reddit)
    runs.update(phase_elastic(reddit)[1])
    runs.update(phase_api(reddit, split_pipes))
    phase_serve()
    phase_lm_train()
    phase_dryrun()
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
