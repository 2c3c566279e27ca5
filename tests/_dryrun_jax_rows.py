"""The JAX package's production dry-run rows, as data: per mesh, each
combo's ``argument_size_in_bytes`` and ``collective_total_bytes`` (per
device), from jax 0.9.0 on the CPU with 512 forced host devices:

  PYTHONPATH=src JAX_PLATFORMS=cpu python -m repro.launch.dryrun --all \
      --out dryrun_16x16.json
  PYTHONPATH=src JAX_PLATFORMS=cpu python -m repro.launch.dryrun --all \
      --multi-pod --out dryrun_2x16x16.json

The port's dry-run tests and chip_smoke.py hold the port's rows to them
through `check_against_jax`; the card machine has no JAX, so they are
written down here (tests/test_torch_dryrun.py recomputes two of them from
the JAX package).
"""

ARGUMENT_BYTES = {
    "16x16": {
        ("whisper-large-v3", "train_4k"): 1_027_468_612,
        ("whisper-large-v3", "prefill_32k"): 872_131_584,
        ("whisper-large-v3", "decode_32k"): 4_751_324_196,
        ("whisper-large-v3", "long_500k"): 388_592_648,
        ("qwen1.5-32b", "train_4k"): 22_014_732_292,
        ("qwen1.5-32b", "prefill_32k"): 9_771_812_864,
        ("qwen1.5-32b", "decode_32k"): 25_877_678_116,
        ("qwen1.5-32b", "long_500k"): 4_738_385_928,
        ("deepseek-v2-236b", "train_4k"): 153_880_332_292,
        ("deepseek-v2-236b", "prefill_32k"): 31_059_339_264,
        ("deepseek-v2-236b", "decode_32k"): 31_908_423_716,
        ("deepseek-v2-236b", "long_500k"): 30_793_656_328,
        ("codeqwen1.5-7b", "train_4k"): 5_130_969_092,
        ("codeqwen1.5-7b", "prefill_32k"): 3_173_834_752,
        ("codeqwen1.5-7b", "decode_32k"): 9_616_023_588,
        ("codeqwen1.5-7b", "long_500k"): 1_160_306_696,
        ("granite-moe-1b-a400m", "train_4k"): 843_819_012,
        ("granite-moe-1b-a400m", "prefill_32k"): 370_247_680,
        ("granite-moe-1b-a400m", "decode_32k"): 973_965_348,
        ("granite-moe-1b-a400m", "long_500k"): 181_241_864,
        ("mamba2-780m", "train_4k"): 489_707_076,
        ("mamba2-780m", "prefill_32k"): 98_099_392,
        ("mamba2-780m", "decode_32k"): 136_065_248,
        ("mamba2-780m", "long_500k"): 102_615_748,
        ("llama-3.2-vision-11b", "train_4k"): 6_326_755_412,
        ("llama-3.2-vision-11b", "prefill_32k"): 1_786_650_640,
        ("llama-3.2-vision-11b", "decode_32k"): 3_388_612_660,
        ("llama-3.2-vision-11b", "long_500k"): 1_251_745_816,
        ("recurrentgemma-2b", "train_4k"): 1_810_853_252,
        ("recurrentgemma-2b", "prefill_32k"): 362_332_544,
        ("recurrentgemma-2b", "decode_32k"): 370_689_444,
        ("recurrentgemma-2b", "long_500k"): 363_147_784,
        ("qwen3-8b", "train_4k"): 5_131_143_172,
        ("qwen3-8b", "prefill_32k"): 1_630_365_696,
        ("qwen3-8b", "decode_32k"): 3_442_042_916,
        ("qwen3-8b", "long_500k"): 1_063_872_520,
        ("starcoder2-3b", "train_4k"): 1_993_198_212,
        ("starcoder2-3b", "prefill_32k"): 398_796_928,
        ("starcoder2-3b", "decode_32k"): 461_449_380,
        ("starcoder2-3b", "long_500k"): 406_399_112,
    },
    "2x16x16": {
        ("whisper-large-v3", "train_4k"): 996_486_468,
        ("whisper-large-v3", "prefill_32k"): 532_616_192,
        ("whisper-large-v3", "decode_32k"): 2_426_106_900,
        ("whisper-large-v3", "long_500k"): 388_592_648,
        ("qwen1.5-32b", "train_4k"): 22_014_470_148,
        ("qwen1.5-32b", "prefill_32k"): 7_087_327_232,
        ("qwen1.5-32b", "decode_32k"): 15_140_259_860,
        ("qwen1.5-32b", "long_500k"): 4_738_385_928,
        ("deepseek-v2-236b", "train_4k"): 153_880_070_148,
        ("deepseek-v2-236b", "prefill_32k"): 30_917_650_432,
        ("deepseek-v2-236b", "decode_32k"): 31_342_192_660,
        ("deepseek-v2-236b", "long_500k"): 30_793_656_328,
        ("codeqwen1.5-7b", "train_4k"): 5_130_706_948,
        ("codeqwen1.5-7b", "prefill_32k"): 2_099_961_856,
        ("codeqwen1.5-7b", "decode_32k"): 5_321_056_276,
        ("codeqwen1.5-7b", "long_500k"): 1_160_306_696,
        ("granite-moe-1b-a400m", "train_4k"): 843_556_868,
        ("granite-moe-1b-a400m", "prefill_32k"): 269_453_312,
        ("granite-moe-1b-a400m", "decode_32k"): 571_312_148,
        ("granite-moe-1b-a400m", "long_500k"): 181_241_864,
        ("mamba2-780m", "train_4k"): 489_444_932,
        ("mamba2-780m", "prefill_32k"): 97_968_320,
        ("mamba2-780m", "decode_32k"): 116_951_248,
        ("mamba2-780m", "long_500k"): 102_615_748,
        ("llama-3.2-vision-11b", "train_4k"): 6_221_635_668,
        ("llama-3.2-vision-11b", "prefill_32k"): 1_504_976_912,
        ("llama-3.2-vision-11b", "decode_32k"): 2_301_763_620,
        ("llama-3.2-vision-11b", "long_500k"): 1_251_745_816,
        ("recurrentgemma-2b", "train_4k"): 1_810_591_108,
        ("recurrentgemma-2b", "prefill_32k"): 362_201_472,
        ("recurrentgemma-2b", "decode_32k"): 366_379_924,
        ("recurrentgemma-2b", "long_500k"): 363_147_784,
        ("qwen3-8b", "train_4k"): 5_130_881_028,
        ("qwen3-8b", "prefill_32k"): 1_328_244_736,
        ("qwen3-8b", "decode_32k"): 2_234_083_348,
        ("qwen3-8b", "long_500k"): 1_063_872_520,
        ("starcoder2-3b", "train_4k"): 1_992_936_068,
        ("starcoder2-3b", "prefill_32k"): 398_665_856,
        ("starcoder2-3b", "decode_32k"): 429_992_084,
        ("starcoder2-3b", "long_500k"): 406_399_112,
    },
}

COLLECTIVE_BYTES = {
    "16x16": {
        ("whisper-large-v3", "train_4k"): 181_495_724_036,
        ("whisper-large-v3", "prefill_32k"): 44_882_657_280,
        ("whisper-large-v3", "decode_32k"): 10_895_360,
        ("whisper-large-v3", "long_500k"): 1_280_000,
        ("qwen1.5-32b", "train_4k"): 773_847_519_236,
        ("qwen1.5-32b", "prefill_32k"): 205_353_123_840,
        ("qwen1.5-32b", "decode_32k"): 68_485_120,
        ("qwen1.5-32b", "long_500k"): 7_577_600,
        ("deepseek-v2-236b", "train_4k"): 2_649_054_394_920,
        ("deepseek-v2-236b", "prefill_32k"): 12_995_388_243_968,
        ("deepseek-v2-236b", "decode_32k"): 5_692_017_664,
        ("deepseek-v2-236b", "long_500k"): 548_451_200,
        ("codeqwen1.5-7b", "train_4k"): 279_078_354_948,
        ("codeqwen1.5-7b", "prefill_32k"): 69_793_218_560,
        ("codeqwen1.5-7b", "decode_32k"): 8_519_680,
        ("codeqwen1.5-7b", "long_500k"): 1_064_960,
        ("granite-moe-1b-a400m", "train_4k"): 266_466_365_732,
        ("granite-moe-1b-a400m", "prefill_32k"): 228_975_443_968,
        ("granite-moe-1b-a400m", "decode_32k"): 31_219_712,
        ("granite-moe-1b-a400m", "long_500k"): 446_464,
        ("mamba2-780m", "train_4k"): 134_777_780_932,
        ("mamba2-780m", "prefill_32k"): 65_997_373_440,
        ("mamba2-780m", "decode_32k"): 7_017_984,
        ("mamba2-780m", "long_500k"): 877_248,
        ("llama-3.2-vision-11b", "train_4k"): 338_083_987_492,
        ("llama-3.2-vision-11b", "prefill_32k"): 89_146_785_792,
        ("llama-3.2-vision-11b", "decode_32k"): 29_442_048,
        ("llama-3.2-vision-11b", "long_500k"): 2_492_416,
        ("recurrentgemma-2b", "train_4k"): 201_410_041_348,
        ("recurrentgemma-2b", "prefill_32k"): 51_405_389_824,
        ("recurrentgemma-2b", "decode_32k"): 7_918_592,
        ("recurrentgemma-2b", "long_500k"): 840_064,
        ("qwen3-8b", "train_4k"): 320_714_250_244,
        ("qwen3-8b", "prefill_32k"): 80_808_509_440,
        ("qwen3-8b", "decode_32k"): 27_042_944,
        ("qwen3-8b", "long_500k"): 2_311_312,
        ("starcoder2-3b", "train_4k"): 186_622_300_420,
        ("starcoder2-3b", "prefill_32k"): 54_156_853_248,
        ("starcoder2-3b", "decode_32k"): 17_839_104,
        ("starcoder2-3b", "long_500k"): 1_584_768,
    },
    "2x16x16": {
        ("whisper-large-v3", "train_4k"): 90_949_482_500,
        ("whisper-large-v3", "prefill_32k"): 22_441_328_640,
        ("whisper-large-v3", "decode_32k"): 5_447_680,
        ("whisper-large-v3", "long_500k"): 1_280_000,
        ("qwen1.5-32b", "train_4k"): 391_326_601_220,
        ("qwen1.5-32b", "prefill_32k"): 102_676_561_920,
        ("qwen1.5-32b", "decode_32k"): 34_242_560,
        ("qwen1.5-32b", "long_500k"): 7_577_600,
        ("deepseek-v2-236b", "train_4k"): 2_304_360_462_888,
        ("deepseek-v2-236b", "prefill_32k"): 12_874_592_288_768,
        ("deepseek-v2-236b", "decode_32k"): 5_637_704_704,
        ("deepseek-v2-236b", "long_500k"): 532_661_120,
        ("codeqwen1.5-7b", "train_4k"): 140_565_266_436,
        ("codeqwen1.5-7b", "prefill_32k"): 34_896_609_280,
        ("codeqwen1.5-7b", "decode_32k"): 4_259_840,
        ("codeqwen1.5-7b", "long_500k"): 1_064_960,
        ("granite-moe-1b-a400m", "train_4k"): 238_952_386_852,
        ("granite-moe-1b-a400m", "prefill_32k"): 221_996_122_112,
        ("granite-moe-1b-a400m", "decode_32k"): 28_733_440,
        ("granite-moe-1b-a400m", "long_500k"): 446_464,
        ("mamba2-780m", "train_4k"): 67_496_557_252,
        ("mamba2-780m", "prefill_32k"): 32_998_686_720,
        ("mamba2-780m", "decode_32k"): 3_508_992,
        ("mamba2-780m", "long_500k"): 877_248,
        ("llama-3.2-vision-11b", "train_4k"): 170_265_296_932,
        ("llama-3.2-vision-11b", "prefill_32k"): 44_573_392_896,
        ("llama-3.2-vision-11b", "decode_32k"): 14_721_024,
        ("llama-3.2-vision-11b", "long_500k"): 2_492_416,
        ("recurrentgemma-2b", "train_4k"): 101_149_005_316,
        ("recurrentgemma-2b", "prefill_32k"): 25_702_694_912,
        ("recurrentgemma-2b", "decode_32k"): 3_959_296,
        ("recurrentgemma-2b", "long_500k"): 834_304,
        ("qwen3-8b", "train_4k"): 161_383_258_116,
        ("qwen3-8b", "prefill_32k"): 40_404_254_720,
        ("qwen3-8b", "decode_32k"): 13_521_472,
        ("qwen3-8b", "long_500k"): 2_311_312,
        ("starcoder2-3b", "train_4k"): 93_709_684_996,
        ("starcoder2-3b", "prefill_32k"): 27_078_426_624,
        ("starcoder2-3b", "decode_32k"): 8_919_552,
        ("starcoder2-3b", "long_500k"): 1_584_768,
    },
}

# the MoE rows whose collectives were 3-15x JAX's (ROADMAP F5), each held
# to FACTOR x JAX's row: (arch, shape, mesh)
F5 = (
    ("deepseek-v2-236b", "train_4k", "16x16"),
    ("deepseek-v2-236b", "prefill_32k", "16x16"),
    ("deepseek-v2-236b", "decode_32k", "16x16"),
    ("granite-moe-1b-a400m", "train_4k", "16x16"),
    ("granite-moe-1b-a400m", "prefill_32k", "16x16"),
    ("deepseek-v2-236b", "train_4k", "2x16x16"),
    ("granite-moe-1b-a400m", "train_4k", "2x16x16"),
)
FACTOR = 4
SCALAR_BYTES = 4        # JAX's int32 position / step count


def moe_output_reduction(arch: str, shape: str, mesh: str) -> tuple:
    """(MoE layers, bytes of one reduction per MoE layer of this rank's
    (tokens, d_model) MoE output): the least the combine's partial sum
    costs, as GSPMD's reduction of JAX's scatter-add. (0, 0) for a dense
    arch."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models.config import INPUT_SHAPES
    cfg, s = get_arch(arch), INPUT_SHAPES[shape]
    layers = sum(cfg.ffn_kind(i) == "moe" for i in range(cfg.num_layers))
    tokens = s.global_batch * (1 if s.mode == "decode" else s.seq_len)
    shards = 32 if mesh == "2x16x16" else 16        # the batch axes
    item = torch.empty((), dtype=getattr(torch, cfg.dtype)).element_size()
    return layers, layers * (tokens // shards) * cfg.d_model * item


def check_against_jax(rows, mesh: str) -> dict:
    """Hold the port's dry-run rows of `mesh` to JAX's: every row's
    collectives counted (their total > 0 and the sum of the types), its
    argument bytes JAX's or the int32 scalar fewer; an MoE row at least
    one all-reduce of its (tokens, d_model) output per MoE layer, and the
    rows of `F5` at most FACTOR x JAX's collective bytes. Returns
    {(arch, shape): (JAX - port argument bytes, port / JAX collective
    bytes)}."""
    out = {}
    for r in rows:
        key = (r["arch"], r["shape"])
        per_type = r["collective_bytes_per_device"]
        assert 0 < r["collective_total_bytes"] == sum(per_type.values()), (
            mesh, key, r["collective_total_bytes"], per_type)
        d = ARGUMENT_BYTES[mesh][key] - r["argument_size_in_bytes"]
        assert 0 <= d <= SCALAR_BYTES, (mesh, key, d)
        ratio = r["collective_total_bytes"] / COLLECTIVE_BYTES[mesh][key]
        layers, floor = moe_output_reduction(*key, mesh)
        if layers:
            assert r["collective_counts_per_device"]["all-reduce"] >= layers, (
                mesh, key, r["collective_counts_per_device"])
            assert per_type["all-reduce"] >= floor, (mesh, key, floor,
                                                     per_type)
        if key + (mesh,) in F5:
            assert ratio <= FACTOR, (mesh, key, ratio)
        out[key] = (d, ratio)
    return out
