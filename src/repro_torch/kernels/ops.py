"""The attention entry point under the JAX package's ``kernels/ops.py``
name: the flash kernel on a CUDA tensor, its plain PyTorch version on a
CPU tensor. PyTorch runs eagerly, so there is no jit and no
``interpret`` switch; the SpMM kernels are called from
``kernels/gcn_spmm.py`` directly."""
from __future__ import annotations

from repro_torch.kernels import flash_attention as _fa


def attention(q, k, v, causal: bool = True, window: int = 0,
              q_block: int = _fa.DEFAULT_Q_BLOCK,
              kv_block: int = _fa.DEFAULT_KV_BLOCK):
    """Flash GQA attention (see flash_attention.py): q (B, S, H, d), k/v
    (B, T, K, d) -> (B, S, H, d)."""
    return _fa.flash_attention(q, k, v, causal=causal, window=window,
                               q_block=q_block, kv_block=kv_block)

