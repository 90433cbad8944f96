"""Blockwise 4-bit (NF4/FP4) quantization, bitsandbytes-checkpoint-compatible
(the port's own copy of ``vision_pt_tpu/ops/quant/nf4.py``).

- packing: two 4-bit codes per uint8, element 2i in the high nibble, over the
  row-major-flattened tensor; the packed tensor is (n//2, 1);
- absmax per ``blocksize`` block (64);
- loading takes double-quantized (nested) stats, since bnb checkpoints ship
  their nested maps; saves write plain fp32 absmax (also a valid bnb format).

The host functions work on numpy arrays; :func:`quantize_4bit_device` and
:func:`quantize_4bit_device_kernel_layout` run the same arithmetic in torch on
the weight's device and give the same codes and absmax, bit for bit.
"""

from __future__ import annotations

import json
from typing import NamedTuple

import numpy as np
import torch

NF4_CODE = np.array(
    [
        -1.0, -0.6961928009986877, -0.5250730514526367, -0.39491748809814453,
        -0.28444138169288635, -0.18477343022823334, -0.09105003625154495, 0.0,
        0.07958029955625534, 0.16093020141124725, 0.24611230194568634,
        0.33791524171829224, 0.44070982933044434, 0.5626170039176941,
        0.7229568362236023, 1.0,
    ],
    dtype=np.float32,
)

# e2m1 values {0, 0.0625, 8, 12, 4, 6, 2, 3}/12, sign in bit 3 (bnb order)
_FP4_POS = np.array([0.0, 0.0625, 8.0, 12.0, 4.0, 6.0, 2.0, 3.0]) / 12.0
FP4_CODE = np.concatenate([_FP4_POS, -_FP4_POS]).astype(np.float32)

CODEBOOKS = {"nf4": NF4_CODE, "fp4": FP4_CODE}

# weights quantized on the device per call of the chunked quantizer: the
# (rows, in) comparisons of a 2.6 B-weight UNet never live at once
_DEVICE_CHUNK_ELEMENTS = 1 << 24


def _nearest_code_indices(values: np.ndarray, code: np.ndarray) -> np.ndarray:
    """Index of the nearest codebook entry per value (ties -> lowest index,
    matching argmin semantics). The codebook may be unsorted (FP4)."""
    order = np.argsort(code, kind="stable")
    sorted_code = code[order]
    mids = (sorted_code[1:] + sorted_code[:-1]) * 0.5
    pos = np.searchsorted(mids, values, side="left")
    # searchsorted against midpoints can land one off at exact boundaries;
    # compare the two candidates explicitly
    lo = np.clip(pos, 0, len(code) - 1)
    hi = np.clip(pos + 1, 0, len(code) - 1)
    pick_hi = np.abs(sorted_code[hi] - values) < np.abs(sorted_code[lo] - values)
    chosen = np.where(pick_hi, hi, lo)
    return order[chosen].astype(np.uint8)


class QuantState4bit(NamedTuple):
    absmax: np.ndarray  # (num_blocks,) float32 (after de-nesting)
    shape: tuple[int, ...]
    blocksize: int
    quant_type: str  # "nf4" | "fp4"
    dtype: str  # original dtype name


def quantize_4bit(
    w: np.ndarray,
    blocksize: int = 64,
    quant_type: str = "nf4",
) -> tuple[np.ndarray, QuantState4bit]:
    """float weights (host) -> (packed uint8 (n//2, 1), state)."""
    code = CODEBOOKS[quant_type]
    shape = tuple(w.shape)
    flat = np.asarray(w, dtype=np.float32).reshape(-1)
    n = flat.size
    assert n % 2 == 0, "4-bit packing requires an even number of elements"
    pad = (-n) % blocksize
    if pad:
        flat = np.concatenate([flat, np.zeros(pad, dtype=np.float32)])
    blocks = flat.reshape(-1, blocksize)
    absmax = np.abs(blocks).max(axis=1)
    safe = np.where(absmax == 0, 1.0, absmax)
    normalized = blocks / safe[:, None]
    idx = _nearest_code_indices(normalized.reshape(-1), code)
    q = idx[:n]
    packed = ((q[0::2] << 4) | q[1::2]).reshape(-1, 1)
    state = QuantState4bit(
        absmax=absmax.astype(np.float32),
        shape=shape,
        blocksize=blocksize,
        quant_type=quant_type,
        dtype="float32",
    )
    return packed, state


def _device_codes(blocks: torch.Tensor, quant_type: str):
    """(nblocks, blocksize) weights -> (uint8 codes of the same shape, fp32
    absmax (nblocks,)), on the weights' device: the JAX package's 15
    unrolled midpoint comparisons and nearest-of-two pick, in fp32."""
    code = CODEBOOKS[quant_type]
    order = np.argsort(code, kind="stable")
    sorted_code = code[order]
    mids = (sorted_code[1:] + sorted_code[:-1]) * 0.5
    blocks = blocks.float()
    absmax = blocks.abs().amax(dim=1)
    safe = torch.where(absmax == 0, torch.ones_like(absmax), absmax)
    v = blocks / safe[:, None]
    pos = torch.zeros(v.shape, dtype=torch.uint8, device=v.device)
    for m in mids:
        pos += v > float(m)
    lo = pos.long()
    hi = (lo + 1).clamp_max(len(code) - 1)
    sc = torch.from_numpy(sorted_code).to(v.device)
    pick_hi = (sc[hi] - v).abs() < (sc[lo] - v).abs()
    order_t = torch.from_numpy(order.astype(np.uint8)).to(v.device)
    return order_t[torch.where(pick_hi, hi, lo)], absmax


def quantize_4bit_device(
    w: torch.Tensor,
    blocksize: int = 64,
    quant_type: str = "nf4",
) -> tuple[np.ndarray, QuantState4bit]:
    """:func:`quantize_4bit` on the weight's device: the same packed codes
    and state, with one host fetch of the result."""
    assert blocksize == 64
    shape = tuple(int(s) for s in w.shape)
    n = int(np.prod(shape))
    assert n % 2 == 0
    flat = w.reshape(-1)
    pad = (-n) % blocksize
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    q, absmax = _device_codes(flat.reshape(-1, blocksize), quant_type)
    q = q.reshape(-1)[:n]
    packed = ((q[0::2] << 4) | q[1::2]).cpu().numpy().reshape(-1, 1)
    state = QuantState4bit(
        absmax=absmax.cpu().numpy().astype(np.float32),
        shape=shape,
        blocksize=blocksize,
        quant_type=quant_type,
        dtype="float32",
    )
    return packed, state


@torch.no_grad()
def quantize_4bit_device_kernel_layout(
    w: torch.Tensor,  # (out, in)
    quant_type: str = "nf4",
    blocksize: int = 64,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Quantize straight into the dequant-matmul kernel's transposed
    deinterleaved layout, on the weight's device: (in//2, out) packed uint8,
    whose byte (r, o) holds input row r in its high nibble and row
    r + in/2 in its low nibble, and (in//blocksize, out) fp32 absmax. Runs
    over row chunks, so the transient comparisons stay small."""
    out_dim, in_dim = w.shape
    assert blocksize == 64 and in_dim % (2 * blocksize) == 0
    packed_t = torch.empty(in_dim // 2, out_dim, dtype=torch.uint8, device=w.device)
    absmax_t = torch.empty(in_dim // blocksize, out_dim, dtype=torch.float32,
                           device=w.device)
    rows = max(1, _DEVICE_CHUNK_ELEMENTS // in_dim)
    for r0 in range(0, out_dim, rows):
        r1 = min(out_dim, r0 + rows)
        q, absmax = _device_codes(w[r0:r1].reshape(-1, blocksize), quant_type)
        q = q.reshape(r1 - r0, in_dim)
        packed_t[:, r0:r1] = ((q[:, : in_dim // 2] << 4) | q[:, in_dim // 2:]).T
        absmax_t[:, r0:r1] = absmax.reshape(r1 - r0, in_dim // blocksize).T
    return packed_t, absmax_t


def unpack_4bit(packed: np.ndarray) -> np.ndarray:
    flat = np.asarray(packed).reshape(-1)
    out = np.empty(flat.size * 2, dtype=np.uint8)
    out[0::2] = flat >> 4
    out[1::2] = flat & 0x0F
    return out


def dequantize_4bit(
    packed: np.ndarray | torch.Tensor,
    state: QuantState4bit,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Packed codes + state -> dense weights, on ``packed``'s device (the
    CPU for a numpy array)."""
    flat = torch.as_tensor(packed).reshape(-1)
    code = torch.from_numpy(CODEBOOKS[state.quant_type]).to(flat.device)
    q = torch.stack([flat >> 4, flat & 0x0F], dim=1).reshape(-1).long()
    values = code[q]
    n = int(np.prod(state.shape))
    pad = (-n) % state.blocksize
    if pad:
        values = torch.cat([values, values.new_zeros(pad)])
    absmax = torch.as_tensor(state.absmax, dtype=torch.float32).to(flat.device)
    dense = (values.reshape(-1, state.blocksize) * absmax[:, None]).reshape(-1)[:n]
    return dense.reshape(state.shape).to(dtype)


# ------------------------------------------------- bnb state (de)serialization


def state_to_bnb_dict(
    state: QuantState4bit, packed_prefix: str = ""
) -> dict[str, np.ndarray]:
    """Uncompressed bnb-format stat tensors (valid Params4bit input)."""
    meta = {
        "blocksize": state.blocksize,
        "dtype": state.dtype,
        "shape": list(state.shape),
        "quant_type": state.quant_type,
    }
    meta_bytes = np.frombuffer(
        json.dumps(meta).encode("utf-8"), dtype=np.uint8
    ).copy()
    p = packed_prefix
    return {
        f"{p}absmax": np.asarray(state.absmax),
        f"{p}quant_map": CODEBOOKS[state.quant_type].copy(),
        f"{p}quant_state.bitsandbytes__{state.quant_type}": meta_bytes,
    }


def state_from_bnb_dict(stats: dict[str, np.ndarray]) -> QuantState4bit:
    """Parse bnb quantized_stats (nested or not) into a flat state."""
    qs_key = next(k for k in stats if "quant_state.bitsandbytes__" in k)
    quant_type = qs_key.split("bitsandbytes__")[-1]
    meta = json.loads(bytes(np.asarray(stats[qs_key], dtype=np.uint8)))
    absmax = np.asarray(stats["absmax"])
    if "nested_absmax" in stats:
        # double-quantized stats: de-nest with the shipped maps
        nested_absmax = np.asarray(stats["nested_absmax"], dtype=np.float32)
        nested_map = np.asarray(stats["nested_quant_map"], dtype=np.float32)
        nested_blocksize = int(meta.get("nested_blocksize", 256))
        offset = float(meta.get("nested_offset", 0.0))
        codes = absmax.astype(np.int32).reshape(-1)
        vals = nested_map[codes]
        nblocks = -(-vals.size // nested_blocksize)
        padded = np.zeros(nblocks * nested_blocksize, dtype=np.float32)
        padded[: vals.size] = vals
        absmax = (
            padded.reshape(nblocks, nested_blocksize)
            * nested_absmax[:nblocks, None]
        ).reshape(-1)[: vals.size] + offset
    return QuantState4bit(
        absmax=absmax.astype(np.float32),
        shape=tuple(meta["shape"]),
        blocksize=int(meta["blocksize"]),
        quant_type=quant_type,
        dtype=str(meta.get("dtype", "float32")),
    )
