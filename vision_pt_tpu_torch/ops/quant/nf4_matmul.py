"""Fused NF4/FP4 dequant-matmul (kernel #9): the port's counterpart of
``vision_pt_tpu/ops/quant/pallas_nf4.py``, whose Pallas TPU kernel
``dequant_matmul_4bit`` it replaces.

``y = x @ dequant(W)^T`` with W (out, in) stored transposed and
deinterleaved: ``packed_t`` (in//2, out) uint8 holds input row r in the high
nibble of byte (r, o) and row r + in/2 in its low nibble; ``absmax_t``
(in//64, out) fp32 holds the scales. For each 64-row chunk j the product of
``x[:, chunk]`` with the UNSCALED codebook values is taken in fp32, times
``absmax_t[j]``, and added to an fp32 accumulator; the result is rounded once
to x's dtype. With bf16 x the codebook values are bf16 (the JAX package's
``_code_i16`` bit patterns), with fp16 x they are the fp32 codebook rounded
to fp16 (the JAX kernel casts its fp32 table to x's dtype), with fp32 x they
are fp32.

On a CUDA tensor :func:`dequant_matmul_4bit` launches the kernel in
``csrc/nf4_matmul.cu`` or raises; on a CPU tensor it runs
:func:`dequant_matmul_4bit_reference`, which repeats the kernel's sums in
the kernel's order, and which the tests hold against the JAX kernel in
interpret mode. The order: the in/128 byte rows of ``packed_t`` (k-steps)
are cut into ``splits`` contiguous ranges (:func:`plan`); each range sums
its k-steps from 0, chunk j then chunk j + in/128 of byte row j; the ranges'
fp32 sums are added in order and rounded once.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import _build
from .nf4 import CODEBOOKS, unpack_4bit

BLOCK = 64  # bnb absmax blocksize; also the per-chunk contraction width
SMS = 132  # streaming multiprocessors of an H100 SXM: the plan fills them

_DTYPE_CODES = {torch.bfloat16: 0, torch.float32: 1, torch.float16: 2}
_fns: dict[str, ctypes._CFuncPtr] = {}
_luts: dict[str, ctypes.Array] = {}  # the codebooks as the C entry takes them


def repack_deinterleaved(packed_bnb: np.ndarray, shape: tuple[int, int]) -> np.ndarray:
    """bnb pair-packed (n//2, 1) -> kernel layout (in//2, out) uint8 where
    high nibbles are input rows [0, in/2) and low nibbles rows [in/2, in)."""
    out_dim, in_dim = shape
    codes = unpack_4bit(packed_bnb).reshape(out_dim, in_dim)
    left = codes[:, : in_dim // 2]
    right = codes[:, in_dim // 2 :]
    return np.ascontiguousarray(((left << 4) | right).astype(np.uint8).T)


def repack_bnb(deint_t: np.ndarray) -> np.ndarray:
    """Inverse of :func:`repack_deinterleaved` -> (n//2, 1) uint8."""
    deint = np.asarray(deint_t).T  # (out, in//2)
    out_dim, half = deint.shape
    codes = np.empty((out_dim, half * 2), dtype=np.uint8)
    codes[:, :half] = deint >> 4
    codes[:, half:] = deint & 0x0F
    flat = codes.reshape(-1)
    return ((flat[0::2] << 4) | flat[1::2]).reshape(-1, 1)


def kernel_supported(in_dim: int, out_dim: int) -> bool:
    return in_dim % (2 * BLOCK) == 0 and out_dim % 8 == 0


def _codebook(quant_type: str, dtype: torch.dtype, device) -> torch.Tensor:
    """The codebook in the kernel's operand type, x's own (rounded to
    nearest even from fp32, as ``_code_i16`` and the JAX kernel's cast)."""
    return torch.from_numpy(CODEBOOKS[quant_type]).to(device).to(dtype)


def plan(rows: int, in_dim: int, out_dim: int, dtype: torch.dtype) -> tuple[int, int]:
    """(block shape, splits) of the kernel for a (rows, in) x (in, out)
    product: the shape's index in ``csrc/nf4_matmul.cu`` (16-bit x: 64 x 64
    tiles up to 64 rows, two blocks an SM; 128 x 64 up to 128 and 256 x 32
    above, one; fp32 x: 64 x 64, one) and the number of contiguous ranges K
    is cut into: as many as one wave of blocks holds, each range at least
    two k-steps."""
    per_sm = 1
    if dtype == torch.float32:
        shape, bm, bn = 0, 64, 64
    elif rows <= 64:
        shape, bm, bn, per_sm = 0, 64, 64, 2
    elif rows <= 128:
        shape, bm, bn = 1, 128, 64
    else:
        shape, bm, bn = 2, 256, 32
    tiles = -(-rows // bm) * -(-out_dim // bn)
    steps = in_dim // (2 * BLOCK)
    return shape, max(1, min(steps // 2, per_sm * SMS // tiles))


def dequant_matmul_4bit_reference(x, packed_t, absmax_t, quant_type: str = "nf4"):
    """Plain PyTorch version of the kernel, chunk by chunk in its order: each
    of the plan's K ranges from 0, then the ranges in turn."""
    lead, in_dim = x.shape[:-1], x.shape[-1]
    out_dim = packed_t.shape[1]
    x2 = x.reshape(-1, in_dim).float()
    code = _codebook(quant_type, x.dtype, x.device).float()
    p = packed_t.long()
    w = torch.cat([code[p >> 4], code[p & 0x0F]], dim=0)  # (in, out) unscaled
    scales = absmax_t.float()
    steps = in_dim // (2 * BLOCK)
    splits = plan(x2.shape[0], in_dim, out_dim, x.dtype)[1]
    total = None
    for split in range(splits):
        acc = torch.zeros(x2.shape[0], out_dim, dtype=torch.float32, device=x.device)
        for row in range(split * steps // splits, (split + 1) * steps // splits):
            for j in (row, row + steps):
                chunk = slice(j * BLOCK, (j + 1) * BLOCK)
                acc = acc + (x2[:, chunk] @ w[chunk]) * scales[j]
        total = acc if total is None else total + acc
    return total.to(x.dtype).reshape(*lead, out_dim)


def _kernel_fn():
    """The C entry point of ``csrc/nf4_matmul.cu``, built and bound at first
    use."""
    if "fwd" not in _fns:
        ptr, i = ctypes.c_void_p, ctypes.c_int
        fn = _build.load("nf4_matmul").vpt_nf4_matmul
        fn.argtypes = [ptr, ptr, ptr, ptr, ptr, i, i, i, ptr, i, i, i, ptr]
        fn.restype = ctypes.c_int
        _fns["fwd"] = fn
    return _fns["fwd"]


def _aligned(t: torch.Tensor, align: int) -> torch.Tensor:
    """``t`` contiguous with its data ``align``-byte aligned (a copy only
    for a view that is not)."""
    t = t.contiguous()
    return t if t.data_ptr() % align == 0 else t.clone()


def dequant_matmul_4bit(x, packed_t, absmax_t, quant_type: str = "nf4"):
    """y[..., out] = x @ dequant(W).T for x (..., in) bf16, fp16 or fp32. Launches
    the CUDA kernel for a CUDA tensor and raises if it cannot; a CPU tensor
    gets the plain version."""
    if x.device.type == "cpu":
        return dequant_matmul_4bit_reference(x, packed_t, absmax_t, quant_type)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    in_dim = x.shape[-1]
    half_in, out_dim = packed_t.shape
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"x dtype {x.dtype}: the kernel takes bfloat16, float16 "
                         "or float32")
    if packed_t.dtype != torch.uint8 or absmax_t.dtype != torch.float32:
        raise ValueError("packed_t must be uint8 and absmax_t float32")
    if 2 * half_in != in_dim or tuple(absmax_t.shape) != (in_dim // BLOCK, out_dim):
        raise ValueError(
            f"shapes x {tuple(x.shape)} packed_t {tuple(packed_t.shape)} "
            f"absmax_t {tuple(absmax_t.shape)} do not match"
        )
    if not kernel_supported(in_dim, out_dim):
        raise ValueError(f"in {in_dim} % 128 and out {out_dim} % 8 must be 0")
    if packed_t.device != x.device or absmax_t.device != x.device:
        raise ValueError("x, packed_t and absmax_t must be on one device")
    if quant_type not in CODEBOOKS:
        raise ValueError(f"unknown quant type {quant_type}")
    lead = x.shape[:-1]
    x2 = _aligned(x.reshape(-1, in_dim), 16)
    packed_t, absmax_t = _aligned(packed_t, 8), _aligned(absmax_t, 16)
    rows = x2.shape[0]
    out = torch.empty(rows, out_dim, dtype=x.dtype, device=x.device)
    if rows == 0:
        return out.reshape(*lead, out_dim)
    shape, splits = plan(rows, in_dim, out_dim, x.dtype)
    ws = (torch.empty(splits, rows, out_dim, dtype=torch.float32, device=x.device)
          if splits > 1 else None)
    if quant_type not in _luts:
        _luts[quant_type] = (ctypes.c_float * 16)(*CODEBOOKS[quant_type].tolist())
    rc = _kernel_fn()(
        x2.data_ptr(), packed_t.data_ptr(), absmax_t.data_ptr(), out.data_ptr(),
        None if ws is None else ws.data_ptr(), rows, in_dim, out_dim,
        ctypes.addressof(_luts[quant_type]), _DTYPE_CODES[x.dtype], shape, splits,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"dequant_matmul_4bit kernel launch failed: {rc}")
    dequant_matmul_4bit.launches += 1
    return out.reshape(*lead, out_dim)


# launches of the CUDA kernel (not of the plain version) since the last reset
dequant_matmul_4bit.launches = 0
