"""Boundary-traffic codecs for the PipeGCN exchange wire.

Port of the JAX package's ``repro.core.codec``. Every boundary payload
(forward features, backward feature-gradients) goes through exactly one
codec before it reaches a backend ``exchange`` / ``fused_exchange`` and
through the matching ``decode`` right after, so the step math on either
side always sees the model dtype. ``PipeConfig.wire`` selects the codec;
the normative byte layouts are in ``docs/wire-format.md``, and the encoded
bytes equal the JAX package's byte for byte.

Codecs
------
``f32``   identity pass-through. The wire tensor IS the payload (any float
          dtype — the f64 parity tests ride this path unchanged).
``bf16``  cast to bfloat16 on the wire, cast back on receive. The cast
          rounds to nearest even (f64 through f32, as XLA does); it does
          not truncate.
``int8``  blockwise-scaled symmetric quantization, 1 byte per element plus
          a per-block f32 scale region (4 bytes per ``block`` columns).
``int4``  same, two elements packed per byte (low nibble = even column).

Quantized wire layout (per payload row, along the feature axis):

    [ payload bytes | scales region ]
      int8: F cols    4*ceil(F/block) cols (f32 scales bitcast to uint8)
      int4: ceil(F/2)

The scales ride inside the wire tensor as trailing uint8 columns, so the
exchange stays a dtype-agnostic permutation of leading axes: the sim
transpose, the flat all_to_all and the hierarchical exchange all carry
them, and the packed fused-exchange buffer grows a scales region per layer.

Quantization (symmetric, zero-preserving): per block of ``block`` feature
columns, ``scale = amax / qmax`` computed in the payload's dtype (a true
division on every device) and then cast to f32 (``qmax`` = 127 for int8,
7 for int4; all-zero blocks use scale 1 so zeros round-trip exactly), and
``q = clip(round(x / scale), -qmax, qmax)`` with the scale cast back to
the payload's dtype; round is half to even, as ``jnp.round``. The error
is at most ``scale / 2`` per element.

Guard (``PipeConfig.guard_exchange``): `ChecksumCodec` wraps any codec
and appends one column per wire row holding `row_checksum` of the row,
the sum of its bytes mod 256, as a value in the wire's own dtype. The
receiver recomputes it (`decode_checked`) and falls back to its stale
buffer on a mismatch.

A bitcast is ``t.contiguous().view(dtype)``: a slice of a packed uint8
buffer need not start on a 4-byte boundary, so every bitcast to a wider
dtype copies first.
"""
from __future__ import annotations

import dataclasses

import torch

#: Accepted concrete ``PipeConfig.wire`` values ("auto" resolves per layer
#: via ``repro_torch.analysis.cost.choose_wire_formats``).
WIRE_FORMATS = ("f32", "bf16", "int8", "int4")

#: Default feature-block size for the quantized scale vectors (one f32
#: scale per ``WIRE_BLOCK`` columns).
WIRE_BLOCK = 128


def _nblocks(f: int, block: int) -> int:
    return -(-f // block) if f else 0


def _bitcast(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Reinterpret the last axis of `t` as `dtype` (its bytes unchanged)."""
    return t.contiguous().view(dtype)


@dataclasses.dataclass(frozen=True)
class NativeCodec:
    """Identity codec: the payload ships in its own dtype (4 bytes/elem f32)."""

    name: str = "f32"

    def wire_width(self, f: int) -> int:
        """Feature columns the wire tensor carries for an f-wide payload."""
        return f

    def wire_bytes(self, f: int) -> float:
        """Bytes one f32 payload row of width f occupies on the wire."""
        return 4.0 * f

    def encode(self, x):
        """Pass the payload through unchanged."""
        return x

    def decode(self, wire, f: int, dtype):
        """Restore the pre-pack dtype (undoes fused-pack dtype promotion)."""
        return wire.to(dtype)


@dataclasses.dataclass(frozen=True)
class Bf16Codec:
    """bfloat16 wire cast (the ``compress_boundary`` alias)."""

    name: str = "bf16"

    def wire_width(self, f: int) -> int:
        """Feature columns on the wire (unchanged; the dtype halves bytes)."""
        return f

    def wire_bytes(self, f: int) -> float:
        """Bytes one payload row of width f occupies on the wire."""
        return 2.0 * f

    def encode(self, x):
        """Cast the payload to bfloat16."""
        return x.to(torch.bfloat16)

    def decode(self, wire, f: int, dtype):
        """Cast the received wire tensor back to the model dtype."""
        return wire.to(dtype)


@dataclasses.dataclass(frozen=True)
class QuantCodec:
    """Blockwise-scaled symmetric int8/int4 quantization (uint8 wire).

    ``bits`` is 8 or 4; ``block`` is the feature-block size each f32 scale
    covers. See the module docstring for the wire layout and error bound;
    ``docs/wire-format.md`` is the normative spec.
    """

    bits: int = 8
    block: int = WIRE_BLOCK

    @property
    def name(self) -> str:
        """Wire-format name ("int8" / "int4")."""
        return f"int{self.bits}"

    @property
    def qmax(self) -> int:
        """Largest stored magnitude (127 for int8, 7 for int4)."""
        return (1 << (self.bits - 1)) - 1

    def payload_cols(self, f: int) -> int:
        """uint8 columns holding the quantized values themselves."""
        return f if self.bits == 8 else (f + 1) // 2

    def wire_width(self, f: int) -> int:
        """uint8 columns on the wire: payload + 4 per scale block."""
        return self.payload_cols(f) + 4 * _nblocks(f, self.block)

    def wire_bytes(self, f: int) -> float:
        """Bytes one payload row of width f occupies on the wire."""
        return float(self.wire_width(f))

    def _scales(self, x, f: int):
        """Per-block f32 scales of the (..., F) payload (zero blocks -> 1)."""
        nb = _nblocks(f, self.block)
        xp = torch.nn.functional.pad(x, (0, nb * self.block - f))
        amax = xp.reshape(x.shape[:-1] + (nb, self.block)).abs().amax(-1)
        # qmax as a tensor on the payload's device: PyTorch's CUDA division
        # by a host scalar multiplies by its rounded reciprocal, which is
        # one ulp off the quotient in some blocks
        qmax = torch.full((), self.qmax, dtype=x.dtype, device=x.device)
        one = torch.ones((), dtype=x.dtype, device=x.device)
        return torch.where(amax > 0, amax / qmax, one).to(torch.float32)

    def encode(self, x):
        """Quantize (..., F) to the (..., wire_width(F)) uint8 wire tensor."""
        f = x.shape[-1]
        if f == 0:
            return x.new_zeros(x.shape[:-1] + (0,), dtype=torch.uint8)
        scale = self._scales(x, f)                          # (..., nb) f32
        sfull = scale.repeat_interleave(self.block, dim=-1)[..., :f]
        q = torch.clamp(torch.round(x / sfull.to(x.dtype)),
                        -self.qmax, self.qmax).to(torch.int8)
        if self.bits == 8:
            payload = _bitcast(q, torch.uint8)
        else:
            if f % 2:
                q = torch.nn.functional.pad(q, (0, 1))
            u = _bitcast(q, torch.uint8)
            payload = (u[..., 0::2] & 0xF) | ((u[..., 1::2] & 0xF) << 4)
        return torch.cat([payload, _bitcast(scale, torch.uint8)], dim=-1)

    def decode(self, wire, f: int, dtype):
        """Dequantize the uint8 wire tensor back to a (..., F) `dtype` one."""
        if f == 0:
            return wire.new_zeros(wire.shape[:-1] + (0,), dtype=dtype)
        pc = self.payload_cols(f)
        payload, sbytes = wire[..., :pc], wire[..., pc:]
        scale = _bitcast(sbytes, torch.float32)            # (..., nb)
        if self.bits == 8:
            q = _bitcast(payload, torch.int8).to(torch.int32)
        else:
            lo = (payload & 0xF).to(torch.int32)
            hi = ((payload >> 4) & 0xF).to(torch.int32)
            q = torch.stack([lo, hi], dim=-1).reshape(
                payload.shape[:-1] + (2 * pc,))[..., :f]
            q = torch.where(q >= 8, q - 16, q)
        sfull = scale.repeat_interleave(self.block, dim=-1)[..., :f]
        return q.to(dtype) * sfull.to(dtype)


def row_checksum(wire):
    """Per-row checksum of a wire tensor: the sum of the row's bytes mod
    256, over the exact bytes on the wire (floats are bitcast, not
    rounded), so any single flipped bit changes it. Returns an int32
    tensor of shape ``wire.shape[:-1]``.

    The bytes are summed as uint8 with a uint8 result: the reduction
    accumulates in a wider integer and the cast back keeps the sum mod
    256, exactly. Asking for an int32 result instead would make PyTorch
    cast the whole input to int32 first (a 4x copy of the wire). A float
    wire whose last axis is contiguous is viewed as bytes where it lies,
    without a copy."""
    if wire.dtype == torch.uint8:
        b = wire
    elif wire.stride(-1) == 1:
        b = wire.view(torch.uint8)
    else:
        b = _bitcast(wire, torch.uint8)
    return torch.sum(b, dim=-1, dtype=torch.uint8).to(torch.int32)


@dataclasses.dataclass(frozen=True)
class ChecksumCodec:
    """Guard wrapper (``PipeConfig.guard_exchange``): any inner codec plus
    ONE trailing checksum column per wire row.

    The column stores ``row_checksum`` of the inner wire row as a small
    integer value (0..255) in the wire's own dtype — exact in uint8,
    bfloat16, f32 and f64, so it survives the fused pack's float promotion
    (`decode_checked` casts the row back to the inner wire dtype before
    summing again). Riding inside the wire keeps the exchange a pure
    permutation: no extra collective. ``name`` is the inner codec's."""

    inner: NativeCodec | Bf16Codec | QuantCodec

    @property
    def name(self) -> str:
        """The wrapped codec's wire-format name (the guard is orthogonal)."""
        return self.inner.name

    def wire_width(self, f: int) -> int:
        """Inner wire columns plus the checksum column."""
        return self.inner.wire_width(f) + 1

    def wire_bytes(self, f: int) -> float:
        """Inner wire bytes plus one column in the wire dtype."""
        extra = 1.0 if isinstance(self.inner, QuantCodec) else \
            self.inner.wire_bytes(1)
        return self.inner.wire_bytes(f) + extra

    def _wire_dtype(self, dtype):
        """The inner codec's on-wire dtype (to undo pack promotion)."""
        if isinstance(self.inner, QuantCodec):
            return torch.uint8
        if isinstance(self.inner, Bf16Codec):
            return torch.bfloat16
        return dtype

    def encode(self, x):
        """Inner-encode, then append the per-row checksum column."""
        wire = self.inner.encode(x)
        c = row_checksum(wire).to(wire.dtype)
        return torch.cat([wire, c[..., None]], dim=-1)

    def _split(self, wire, f: int, dtype):
        pc = self.inner.wire_width(f)
        return wire[..., :pc].to(self._wire_dtype(dtype)), wire[..., pc]

    def decode(self, wire, f: int, dtype):
        """Strip the checksum column and inner-decode (no verification:
        the receive path uses `decode_checked`)."""
        return self.inner.decode(self._split(wire, f, dtype)[0], f, dtype)

    def decode_checked(self, wire, f: int, dtype):
        """Decode and verify: ``(payload, valid)``, ``valid`` a per-row
        bool of shape ``wire.shape[:-1]``, True iff the recomputed
        checksum equals the stored column (a corrupted stored column,
        NaN included, reads as invalid)."""
        inner_wire, stored = self._split(wire, f, dtype)
        valid = stored == row_checksum(inner_wire).to(wire.dtype)
        return self.inner.decode(inner_wire, f, dtype), valid


def make_codec(wire: str, block: int = WIRE_BLOCK, guard: bool = False):
    """The codec instance for one resolved wire-format name; ``guard=True``
    wraps it in a `ChecksumCodec` (one extra column per row)."""
    if wire == "f32":
        codec = NativeCodec()
    elif wire == "bf16":
        codec = Bf16Codec()
    elif wire == "int8":
        codec = QuantCodec(bits=8, block=block)
    elif wire == "int4":
        codec = QuantCodec(bits=4, block=block)
    else:
        raise ValueError(f"unknown wire format {wire!r}; have {WIRE_FORMATS}")
    return ChecksumCodec(codec) if guard else codec


# ----------------------------------------------------------------------
# Byte planarization for the packed fused-exchange buffer.
#
# A fused pack concatenates per-layer wire tensors along the feature axis.
# All-float plans keep the plain concat (dtype promotion is undone by each
# codec's decode, bit-identically); a plan that mixes quantized uint8 wires
# with float wires would let the concat promote the raw bytes to floats —
# values survive, but every byte would ship 2- or 4-wide. These helpers
# bitcast float wires to uint8 columns instead, so a mixed "auto" plan
# still packs into one dense byte buffer.
# ----------------------------------------------------------------------

def byteify(wire):
    """(..., F) wire tensor -> ((..., F*itemsize) uint8, itemsize, dtype)."""
    if wire.dtype == torch.uint8:
        return wire, 1, wire.dtype
    return _bitcast(wire, torch.uint8), wire.element_size(), wire.dtype


def unbyteify(bytes_arr, itemsize: int, dtype):
    """Inverse of `byteify` given its (itemsize, dtype) record."""
    if itemsize == 1:
        return bytes_arr
    return _bitcast(bytes_arr, dtype)


def _mixed(wires) -> bool:
    """Whether a pack mixes uint8 wires with wires of another dtype."""
    dtypes = {w.dtype for w in wires}
    return len(dtypes) > 1 and torch.uint8 in dtypes


def _unbyteify_all(recvs, planar):
    return [unbyteify(r, it, dt) for r, (_, it, dt) in zip(recvs, planar)]


def fused_exchange_encoded(backend, wires):
    """``backend.fused_exchange`` over already-encoded per-layer wires.

    Byte-planarizes exactly when the pack mixes quantized (uint8) and
    float wires; homogeneous plans take the plain packed exchange, so the
    fused schedule stays bit-identical to the per-layer one under every
    codec."""
    if not _mixed(wires):
        return backend.fused_exchange(list(wires))
    planar = [byteify(w) for w in wires]
    return _unbyteify_all(
        backend.fused_exchange([b for b, _, _ in planar]), planar)


def start_fused_exchange_encoded(backend, wires):
    """`fused_exchange_encoded` started now (``backend.start_fused_exchange``):
    the handle's `wait()` gives the per-layer received wires."""
    if not _mixed(wires):
        return backend.start_fused_exchange(list(wires))
    from repro_torch.core.pipegcn import _Then   # pipegcn imports codec
    planar = [byteify(w) for w in wires]
    return _Then(backend.start_fused_exchange([b for b, _, _ in planar]),
                 lambda recvs: _unbyteify_all(recvs, planar))
