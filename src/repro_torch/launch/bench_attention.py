"""Time the flash-attention kernel on the card over its compile-time tile
sizes, at the attention shapes chip_smoke.py launches it at.

    python -m repro_torch.launch.bench_attention [--warps 4,8] [--bk 32,64]
                                   [--stages 2,3] [--split 0,1] [--rm 1,2]

Every combination of the listed values is a build of csrc/flash_attention.cu
with -DFA_NW, -DFA_BK, -DFA_STAGES, -DFA_SPLIT and -DFA_RM (an empty list
leaves that size to the source), which replace the source's tile_sizes for
every head width and dtype: warps per block, keys per k / v tile, cp.async
ring stages, for f32 whether k and v are split into hi and lo once per tile
in shared memory, and the 16-row m-tiles each warp owns. The builds run in
parallel; the shipped build is timed beside them. A variant whose shared
memory does not fit is reported as not launching.

Cases (B = 1; q, k, v ~ N(0, 1) from a seeded generator): chip_smoke.py's
attention shapes, qwen3-8b causal S = 8192 (H 32, K 8, d 128) in f32 and
bf16, starcoder2-3b (H 24, K 2, d 128, window 4096), recurrentgemma-2b (H
10, K 1, d 256, window 2048) and qwen3-8b not causal S = 4096 in f32;
and, to choose the tiles of the instances chip_smoke does not time,
recurrentgemma-2b in bf16 and d = 32 and 64 at qwen3-8b's heads (causal S
= 8192) in both dtypes. Each variant's output is held against
flash_attention_plain once (f32 rtol = atol = 2e-5, bf16 atol 5e-2). Times
are CUDA-event means of 5 launches, taken in turns (through the variants,
then back). Prints the card's name and power limit, the rate mma.sync
alone reaches (csrc/probe/mma_ceiling.cu, TF32 and bf16 TFLOP/s), one JSON
line per case and variant (ms, TFLOP/s, share of the tensor-core bound,
registers, spill bytes, max error), and last the fastest variant per head
width and dtype by the sum of its cases' times, among those that hold the
bar and do not spill.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import itertools
import json
import re
import subprocess

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as fa

PEAK_BF16_FLOPS = 989e12    # H100 SXM bf16 tensor cores, dense (data sheet)
PEAK_TF32_FLOPS = 495e12    # H100 SXM TF32 tensor cores, dense (data sheet)
PEAK_BYTES = 3.35e12        # H100 SXM HBM3 bytes/s (data sheet)
F32, BF16 = torch.float32, torch.bfloat16
SHIPPED = "shipped"

# (label, S, H, K, d, causal, window, dtypes)
CASES = (
    ("qwen3-8b causal", 8192, 32, 8, 128, True, 0, (F32, BF16)),
    ("starcoder2-3b window 4096", 8192, 24, 2, 128, True, 4096, (F32,)),
    ("recurrentgemma-2b window 2048", 8192, 10, 1, 256, True, 2048,
     (F32, BF16)),
    ("qwen3-8b full S=4096", 4096, 32, 8, 128, False, 0, (F32,)),
    ("d=64 at qwen3-8b heads, causal", 8192, 32, 8, 64, True, 0, (F32, BF16)),
    ("d=32 at qwen3-8b heads, causal", 8192, 32, 8, 32, True, 0, (F32, BF16)),
)
INSTANCE = re.compile(r"flash_attention_kernelILi(\d+)E(13__nv_bfloat16|f)E")


def _event_ms(fn, reps: int = 5) -> float:
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


def _instances(path) -> dict:
    """(d, dtype) -> registers and spill bytes of that kernel instance."""
    out = {}
    for name, r in _build.kernel_resources(path).items():
        m = INSTANCE.search(name)
        if m:
            dtype = F32 if m.group(2) == "f" else BF16
            out[int(m.group(1)), dtype] = dict(
                registers=r["registers"], spill_bytes=r["stack"] + r["local"])
    return out


def _mma_ceiling() -> dict:
    """TFLOP/s of mma.sync alone (csrc/probe/mma_ceiling.cu): chains of
    independent TF32 m16n8k8 or bf16 m16n8k16 steps from registers, 8 per
    warp, in 132 × 8 blocks of 8 warps."""
    lib = _build.load("probe/mma_ceiling")
    lib.mma_ceiling.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
    blocks, iters = 132 * 8, 4096
    out = torch.empty(blocks * 256, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    rates = {}
    for tf32, name, depth in ((1, "tf32", 8), (0, "bf16", 16)):
        def run():
            code = lib.mma_ceiling(tf32, blocks, iters, out.data_ptr(), stream)
            if code:
                raise RuntimeError(f"mma_ceiling: cudaError {code}")
        flops = blocks * 8 * iters * 8 * 2 * 16 * 8 * depth
        rates[name + "_tflops"] = flops / _event_ms(run) / 1e9
    return rates


def _pairs(s: int, causal: bool, window: int) -> int:
    """Unmasked (query, key) pairs of one head, S = T = s."""
    r = torch.arange(s, dtype=torch.int64)
    hi = r if causal else torch.full_like(r, s - 1)
    lo = (r - window + 1).clamp(min=0) if window else torch.zeros_like(r)
    return int((hi - lo + 1).clamp(min=0).sum())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--warps", default="4,8")
    ap.add_argument("--bk", default="32,64")
    ap.add_argument("--stages", default="2,3")
    ap.add_argument("--split", default="",
                    help="f32: split k and v once per tile in shared memory "
                         "(1) or per warp in registers (0); empty = the "
                         "source's choice")
    ap.add_argument("--rm", default="",
                    help="16-row m-tiles per warp (1, 2); empty = the "
                         "source's choice")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_attention: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    print(json.dumps({"mma_sync_ceiling": _mma_ceiling()}), flush=True)
    variants = {SHIPPED: ()}
    knobs = (("warps", "FA_NW", args.warps), ("bk", "FA_BK", args.bk),
             ("stages", "FA_STAGES", args.stages),
             ("split", "FA_SPLIT", args.split), ("rm", "FA_RM", args.rm))
    for combo in itertools.product(*(
            [(label, macro, v) for v in values.split(",")] if values
            else [None] for label, macro, values in knobs)):
        picked = [c for c in combo if c]
        variants[" ".join(f"{label}={v}" for label, _, v in picked)] = tuple(
            f"{macro}={v}" for _, macro, v in picked)
    with concurrent.futures.ThreadPoolExecutor(len(variants)) as pool:
        paths = dict(zip(variants, pool.map(
            lambda d: _build.build("flash_attention", d)[0],
            variants.values())))
    libs = {k: fa._library(d) for k, d in variants.items()}
    builds = {k: _instances(p) for k, p in paths.items()}

    gen = torch.Generator(device="cuda").manual_seed(0)
    totals = {}
    for label, s, h, kh, d, causal, window, dtypes in CASES:
        flops = 4.0 * d * h * _pairs(s, causal, window)
        for dtype in dtypes:
            q = torch.randn(1, s, h, d, device="cuda", generator=gen).to(dtype)
            k, v = (torch.randn(1, s, kh, d, device="cuda",
                                generator=gen).to(dtype) for _ in range(2))
            want = fa.flash_attention_plain(q, k, v, causal=causal,
                                            window=window)
            rows, runs = {}, {}
            for name, lib in libs.items():
                try:
                    got = fa.launch(lib, q, k, v, causal, window)
                except RuntimeError as err:
                    rows[name] = dict(launches=False, error=str(err))
                    continue
                torch.cuda.synchronize()
                tol = 2e-5 if dtype == F32 else 0.0
                bar = 2e-5 if dtype == F32 else 5e-2
                diff = (got.float() - want.float()).abs()
                ok = bool((diff <= bar + tol * want.float().abs()).all())
                rows[name] = dict(launches=True, max_abs_err=float(diff.max()),
                                  within_bar=ok, **builds[name][d, dtype])
                runs[name] = (lambda lib=lib: fa.launch(lib, q, k, v, causal,
                                                        window))
            times = {n: [] for n in runs}
            for order in (list(runs), list(runs)[::-1]):
                for n in order:
                    times[n].append(_event_ms(runs[n]))
            t_ops = (3 * flops / PEAK_TF32_FLOPS if dtype == F32
                     else flops / PEAK_BF16_FLOPS)
            t_bytes = q.element_size() * (2 * q.numel() + 2 * k.numel()) / PEAK_BYTES
            bound_ms = 1e3 * max(t_ops, t_bytes)
            per = totals.setdefault((d, str(dtype).split(".")[1]), {})
            for n, row in rows.items():
                ms = float("inf")
                if n in times:
                    ms = sum(times[n]) / len(times[n])
                    row.update(ms=ms, tflops=flops / ms / 1e9,
                               bound_ms=bound_ms, bound_share=bound_ms / ms)
                # a variant that fails a case or spills cannot be chosen
                ok = row.get("within_bar") and not row.get("spill_bytes")
                per[n] = per.get(n, 0.0) + (ms if ok else float("inf"))
                print(json.dumps(dict(case=label, dtype=str(dtype), d=d,
                                      variant=n, **row)), flush=True)
            del q, k, v, want
    for key, per in sorted(totals.items()):
        best = min(per, key=per.get)
        print(json.dumps(dict(best_for=dict(d=key[0], dtype=key[1]),
                              variant=best, total_ms=per[best],
                              shipped_total_ms=per.get(SHIPPED))), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
